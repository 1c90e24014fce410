"""Dependency-free local HTTP ranking service over :class:`Scorer`.

The port's counterpart of the JAX package's ``serve/http_service.py``,
with the same endpoints and JSON (stdlib ``ThreadingHTTPServer``):

* ``GET /healthz`` -> ``{"status": "ok", "feature_size": F}``
* ``POST /v1/rank`` with body::

      {"queries": [[[f...], [f...]], ...]}   # per query: list of feature
                                             # vectors, one per candidate

  -> ``{"ranked": [[doc indices best-first], ...],
        "scores": [[score per candidate, input order], ...]}``

Device work goes through a ``MicroBatcher`` when one is given, else it
is serialised with a lock (one card, many HTTP threads).
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ultra_pytorch_tpu_torch.serve.scorer import Scorer


def make_server(scorer: Scorer, host: str = "127.0.0.1",
                port: int = 0, batcher=None,
                max_body_bytes: int = 64 << 20,
                max_queries: int = 1024,
                max_list_len: int = 1024) -> ThreadingHTTPServer:
    """Build (but do not start) the HTTP server; ``port=0`` auto-picks.

    With a ``serve.batching.MicroBatcher``, concurrent requests coalesce
    into single device calls; otherwise device work serializes on a lock.

    ``max_body_bytes`` / ``max_queries`` / ``max_list_len`` bound each
    request (413/400) BEFORE any allocation or device work — an oversized
    request would otherwise trigger a huge host and device allocation on
    the request path.
    """
    lock = threading.Lock()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet by default
            pass

        def _reply(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, {"status": "ok",
                                  "feature_size": scorer.feature_size})
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            if self.path != "/v1/rank":
                self._reply(404, {"error": f"unknown path {self.path}"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                if length > max_body_bytes:
                    self._reply(413, {"error": f"request body {length} B "
                                      f"exceeds limit {max_body_bytes} B"})
                    return
                req = json.loads(self.rfile.read(length) or b"{}")
                queries = req["queries"]
                if not queries:
                    raise ValueError("empty 'queries'")
                if len(queries) > max_queries:
                    raise ValueError(f"{len(queries)} queries exceeds "
                                     f"limit {max_queries}")
                n_valid = [len(q) for q in queries]
                max_len = max(n_valid)
                if max_len > max_list_len:
                    raise ValueError(f"list of {max_len} docs exceeds "
                                     f"limit {max_list_len}")
                feats = np.zeros(
                    (len(queries), max_len, scorer.feature_size), np.float32)
                for i, q in enumerate(queries):
                    arr = np.asarray(q, np.float32)
                    if arr.ndim != 2 or arr.shape[1] != scorer.feature_size:
                        raise ValueError(
                            f"query {i}: expected [n_docs, "
                            f"{scorer.feature_size}] features, got "
                            f"{list(arr.shape)}")
                    feats[i, : len(q)] = arr
            except (KeyError, ValueError, TypeError) as exc:
                self._reply(400, {"error": str(exc)})
                return
            try:
                if batcher is not None:
                    scores, order = batcher.submit(feats, n_valid)
                else:
                    with lock:
                        scores, order = scorer._score_ranked(feats, n_valid)
            except Exception as exc:  # scoring-time failure -> JSON 500,
                # not a dropped connection (e.g. batcher closed at
                # shutdown, a kernel build failure or a device OOM)
                self._reply(500, {"error": f"{type(exc).__name__}: {exc}"})
                return
            self._reply(200, {
                "ranked": [order[i, : n].tolist()
                           for i, n in enumerate(n_valid)],
                "scores": [scores[i, : n].tolist()
                           for i, n in enumerate(n_valid)],
            })

    class Server(ThreadingHTTPServer):
        # socketserver's default listen backlog is 5; a concurrent client
        # burst beyond it gets kernel connection resets before the handler
        # ever runs.
        request_queue_size = 128

    return Server((host, port), Handler)


def serve(scorer: Scorer, host: str = "127.0.0.1", port: int = 8000,
          warmup_batch: int = 0, warmup_list: int = 0,
          batch_requests: bool = True) -> None:
    """Blocking entry point of ``python -m ultra_pytorch_tpu_torch.serve``."""
    if warmup_batch or warmup_list:
        # A lone flag warms up to that axis' maximum with the other at its
        # minimum bucket.
        scorer.warmup(warmup_batch or scorer.min_batch_bucket,
                      warmup_list or scorer.min_list_bucket)
    batcher = None
    if batch_requests:
        from ultra_pytorch_tpu_torch.serve.batching import MicroBatcher
        batcher = MicroBatcher(scorer)
    server = make_server(scorer, host, port, batcher=batcher)
    print(f"serving on http://{server.server_address[0]}:"
          f"{server.server_address[1]} (feature_size="
          f"{scorer.feature_size})", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()
