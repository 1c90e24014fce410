"""Serving-path throughput: the bucketed ``Scorer``, plain and with K1.

The port's counterpart of the JAX package's ``tools/bench_serve.py``. It
times the call a request makes (``Scorer._score_ranked``: pad into the
bucket's staging, copy in, the bucket's replayed CUDA graph, ranked
read-back) at 8x16, 256x16 and 256x128 (queries x documents) with a
full-width DNN (random weights from a seed), once with ``use_pallas=false``
(the plain library path) and once with K1, over `--iters` calls after a
warm-up call (which captures the bucket). It reports µs a request and
queries/s, and holds K1's replies to the plain ones on the same inputs:
``max_abs_err`` of the scores, whether the orders are equal, and
``order_violations``, the pairs K1 ranks against the plain scores by more
than twice the tolerance (two scores within it may swap).

Usage: python -m ultra_pytorch_tpu_torch.tools.bench_serve [--iters 200]
           [--features 136] [--device cuda]
"""

from __future__ import annotations

import json
import time
from typing import Dict

import numpy as np
import torch

from ultra_pytorch_tpu_torch.tools import bench_common as bc

BUCKETS = ((8, 16), (256, 16), (256, 128))   # (queries, documents)
TOL = 2e-4          # K1 against the plain path (rtol and atol)


def make_scorer(features: int, hidden: str, use_pallas: bool, device,
                seed: int = 0):
    """A `Scorer` over a DNN whose weights come from `seed` (the same for
    both settings of `use_pallas`)."""
    from ultra_pytorch_tpu_torch.models.dnn import DNN
    from ultra_pytorch_tpu_torch.serve.scorer import Scorer

    on = "true" if use_pallas else "false"
    ranker = DNN(f"{hidden},use_pallas={on}", features,
                 generator=torch.Generator().manual_seed(seed))
    return Scorer(ranker, features, device=device)


def order_violations(order: np.ndarray, plain: np.ndarray,
                     slack: float) -> int:
    """Adjacent pairs of `order` (ranked candidate indices a query) whose
    `plain` scores rise by more than `slack`: places where the order is
    not a ranking of the plain scores."""
    ranked = np.take_along_axis(plain, order, axis=1)
    return int((np.diff(ranked, axis=1) > slack).sum())


def bench(device, iters: int = 200, features: int = bc.FEATURES,
          hidden: str = bc.HIDDEN) -> Dict:
    rng = np.random.default_rng(0)
    inputs = {b: rng.normal(size=b + (features,)).astype(np.float32)
              for b in BUCKETS}
    results, us, replies = {}, {}, {}
    before = bc.launch_counts()
    for name, use_pallas in (("plain", False), ("k1", True)):
        scorer = make_scorer(features, hidden, use_pallas, device)
        for (q, length), feats in inputs.items():
            replies[name, q, length] = scorer._score_ranked(feats, None)
            bc.sync(device)
            t0 = time.perf_counter()
            for _ in range(iters):
                scorer._score_ranked(feats, None)
            dt = (time.perf_counter() - t0) / iters
            key = f"{name}_{q}x{length}"
            results[key] = q / dt
            us[key] = dt * 1e6
            print(f"{name:6s} batch {q:4d} x list {length:4d}: "
                  f"{dt * 1e6:9.1f} us/request  {q / dt:12.1f} queries/s",
                  flush=True)
    check = {}
    for q, length in BUCKETS:
        (s_plain, o_plain), (s_k1, o_k1) = (replies["plain", q, length],
                                            replies["k1", q, length])
        check[f"{q}x{length}"] = {
            "max_abs_err": float(np.abs(s_k1 - s_plain).max()),
            "scores_close": bool(np.allclose(s_k1, s_plain, rtol=TOL,
                                             atol=TOL)),
            "orders_equal": bool((o_k1 == o_plain).all()),
            "order_violations": order_violations(o_k1, s_plain, 2 * TOL),
        }
    return {"metric": "serve_throughput", "unit": "queries/s",
            "results": results, "us_per_request": us, "k1_vs_plain": check,
            "tolerance": TOL, "iters": iters, "device": str(device),
            "launches": bc.launches_since(before)}


def main(argv=None) -> Dict:
    p = bc.tool_parser(__doc__.splitlines()[0])
    p.add_argument("--iters", type=int, default=200)
    p.add_argument("--features", type=int, default=bc.FEATURES)
    p.add_argument("--hidden", default=bc.HIDDEN)
    args = p.parse_args(argv)
    device = bc.start(args)
    out = bench(device, args.iters, args.features, args.hidden)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
