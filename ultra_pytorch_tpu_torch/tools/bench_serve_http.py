"""End-to-end serving benchmark through the HTTP stack.

The port's counterpart of the JAX package's ``tools/bench_serve_http.py``.
``bench_serve`` times the ``Scorer``'s call; this tool measures what a
client sees: `--clients` concurrent HTTP clients x `--requests` requests
each, through ``serve.http_service.make_server`` (on a free port) and the
``MicroBatcher``, reporting queries/s, p50/p99 request latency, the
errors and the coalescing factor (requests a device call). It runs once
serialized on the server's lock and once micro-batched. The scorer is a
full-width DNN with random weights from a seed, with K1
(``use_pallas=true``) unless ``--no-pallas``; its buckets are warmed (on
the card, captured) before the burst.

Usage: python -m ultra_pytorch_tpu_torch.tools.bench_serve_http
           [--clients 16] [--requests 8] [--queries 8] [--list-size 16]
           [--features 136] [--no-pallas] [--device cuda]
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request
from typing import Dict, List, Tuple

import numpy as np

from ultra_pytorch_tpu_torch.tools import bench_common as bc
from ultra_pytorch_tpu_torch.tools.bench_serve import make_scorer


def drive(base: str, payload: bytes, clients: int, requests: int,
          timeout: float) -> Tuple[List[float], float, List[str]]:
    """Fire `clients` x `requests` concurrent POSTs; returns the sorted
    latencies (s) of the answered ones, the wall time and the errors (a
    client still running after `timeout` seconds counts as one)."""
    latencies: List[List[float]] = [[] for _ in range(clients)]
    errors: List[str] = []
    barrier = threading.Barrier(clients + 1)

    def client(ci):
        barrier.wait()
        for _ in range(requests):
            req = urllib.request.Request(
                f"{base}/v1/rank", data=payload,
                headers={"Content-Type": "application/json"})
            t0 = time.perf_counter()
            try:
                with urllib.request.urlopen(req, timeout=timeout) as r:
                    r.read()
            except Exception as exc:  # noqa: BLE001 - counted, not raised
                errors.append(repr(exc))
                continue
            latencies[ci].append(time.perf_counter() - t0)

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(clients)]
    for t in threads:
        t.start()
    barrier.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join(timeout)
    wall = time.perf_counter() - t0
    errors += [f"client {i} still running after {timeout} s"
               for i, t in enumerate(threads) if t.is_alive()]
    return sorted(x for c in latencies for x in c), wall, errors


def bench(scorer, clients: int, requests: int, queries: int, list_size: int,
          batch_requests: bool, timeout: float = 600.0) -> Dict:
    """One burst through a fresh server (micro-batched or on the lock);
    the server, its thread and the batcher are stopped before it
    returns."""
    from ultra_pytorch_tpu_torch.serve.batching import MicroBatcher
    from ultra_pytorch_tpu_torch.serve.http_service import make_server

    batcher = MicroBatcher(scorer) if batch_requests else None
    server = make_server(scorer, port=0, batcher=batcher)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        host, port = server.server_address[:2]
        base = f"http://{host}:{port}"
        rng = np.random.default_rng(0)
        payload = json.dumps({"queries": rng.normal(size=(
            queries, list_size, scorer.feature_size)).tolist()}).encode()
        # Every bucket a coalesced burst can reach, before the burst (a
        # bucket's first call captures its graph).
        scorer.warmup(min(clients * queries, 256), list_size)
        drive(base, payload, 1, 1, timeout)
        calls0 = batcher.device_calls if batcher is not None else 0
        flat, wall, errors = drive(base, payload, clients, requests, timeout)
        n_req = len(flat)
        out = {
            "error_samples": sorted(set(errors))[:3],
            "mode": "micro_batched" if batch_requests else "lock_serialized",
            "clients": clients,
            "requests_total": clients * requests,
            "errors": len(errors),
            "queries_per_request": queries,
            "list_size": list_size,
            "wall_s": wall,
            "queries_per_sec": n_req * queries / wall,
            "latency_p50_ms": 1e3 * flat[n_req // 2] if flat else None,
            "latency_p99_ms": (1e3 * flat[min(n_req - 1, int(n_req * 0.99))]
                               if flat else None),
        }
        if batcher is not None:
            out["device_calls"] = batcher.device_calls - calls0
            out["coalescing_factor"] = n_req / max(out["device_calls"], 1)
        return out
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout)
        if batcher is not None:
            batcher.close()


def main(argv=None) -> Dict:
    p = bc.tool_parser(__doc__.splitlines()[0])
    p.add_argument("--clients", type=int, default=16)
    p.add_argument("--requests", type=int, default=8)
    p.add_argument("--queries", type=int, default=8)
    p.add_argument("--list-size", type=int, default=16)
    p.add_argument("--features", type=int, default=bc.FEATURES)
    p.add_argument("--hidden", default=bc.HIDDEN)
    p.add_argument("--no-pallas", action="store_true",
                   help="the plain DNN path instead of K1")
    p.add_argument("--timeout", type=float, default=600.0,
                   help="seconds a request, and a client thread, may take")
    args = p.parse_args(argv)
    device = bc.start(args)
    scorer = make_scorer(args.features, args.hidden, not args.no_pallas,
                         device)
    before = bc.launch_counts()
    rows = []
    for batched in (False, True):
        rows.append(bench(scorer, args.clients, args.requests, args.queries,
                          args.list_size, batched, args.timeout))
        print(json.dumps(rows[-1]), flush=True)
    out = {"metric": "serve_http", "device": str(device),
           "use_pallas": not args.no_pallas, "results": rows,
           "launches": bc.launches_since(before)}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
