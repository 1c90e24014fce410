"""Request micro-batching: coalesce concurrent rank requests into one
device call.

The port's counterpart of the JAX package's ``serve/batching.py``, the
same plain-Python threading. Each device call pays a fixed cost (host
padding, two copies, the launches), so under concurrent load the unit of
work is the coalesced batch: one worker
thread drains whatever requests have queued, pads them into one bucket,
runs a single score+rank call, and scatters the results. Callers block on
their own slice. One device call is in flight at a time.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ultra_pytorch_tpu_torch.serve.scorer import Scorer


class _Pending:
    __slots__ = ("features", "n_valid", "event", "scores", "order", "error")

    def __init__(self, features: np.ndarray, n_valid: np.ndarray):
        self.features = features
        self.n_valid = n_valid
        self.event = threading.Event()
        self.scores = self.order = self.error = None


class MicroBatcher:
    """Blocking ``submit()`` front-end over a single scoring worker."""

    def __init__(self, scorer: Scorer, max_batch: int = 256,
                 max_delay_s: float = 0.002,
                 submit_timeout_s: float = 300.0):
        """Args:
          max_batch: cap on coalesced queries per device call (larger
            waiting requests are split across calls).
          max_delay_s: how long the worker waits for MORE requests after
            the first one arrives — the classic latency/throughput knob.
            The default 2 ms is far below a network round-trip but several
            times a warmed scoring call, so bursts coalesce fully.
          submit_timeout_s: upper bound a caller blocks in ``submit()``
            before a TimeoutError — generous by default because a cold
            bucket's first XLA compile can take minutes through a remote
            compile service, but finite so a wedged device call can't hang
            callers forever.
        """
        self.scorer = scorer
        self.max_batch = max_batch
        self.max_delay_s = max_delay_s
        self.submit_timeout_s = submit_timeout_s
        self._queue: List[_Pending] = []
        self._inflight: List[_Pending] = []  # group the worker is serving
        self._cv = threading.Condition()
        self._closed = False
        self.device_calls = 0  # statistics (also used by tests)
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # -- caller side ------------------------------------------------------
    def submit(self, features: np.ndarray,
               n_valid: Optional[Sequence[int]] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Score+rank ``[Q, L, F]`` lists; blocks until results are ready.

        Returns ``(scores [Q, L], ranked_indices [Q, L])`` exactly like
        ``Scorer._score_ranked``.
        """
        features = np.asarray(features, np.float32)
        if features.ndim == 2:
            features = features[None]
        q, length, f = features.shape
        if f != self.scorer.feature_size:
            raise ValueError(
                f"feature size {f} != model feature size "
                f"{self.scorer.feature_size}")
        n_valid = (np.full(q, length, np.int32) if n_valid is None
                   else np.asarray(n_valid, np.int32))
        item = _Pending(features, n_valid)
        with self._cv:
            if self._closed:
                raise RuntimeError("MicroBatcher is closed")
            self._queue.append(item)
            self._cv.notify()
        if not item.event.wait(timeout=self.submit_timeout_s):
            raise TimeoutError(
                f"rank request not served within {self.submit_timeout_s}s")
        if item.error is not None:
            raise item.error
        return item.scores, item.order

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify()
        self._worker.join(timeout=5)
        if self._worker.is_alive():
            # Worker is wedged (e.g. a hung device call): fail any items
            # still queued AND the group already popped into the wedged
            # device call, so every caller wakes instead of blocking for
            # the full submit timeout.
            with self._cv:
                pending = self._queue + self._inflight
                self._queue = []
            for p in pending:
                if not p.event.is_set():
                    p.error = RuntimeError(
                        "MicroBatcher closed before serving this request")
                    p.event.set()

    # -- worker side ------------------------------------------------------
    def _take_group(self) -> Optional[List[_Pending]]:
        """Block for the first request, linger max_delay_s for stragglers,
        then take up to max_batch queries' worth of requests."""
        with self._cv:
            while not self._queue and not self._closed:
                self._cv.wait()
            if self._closed and not self._queue:
                return None
        if self.max_delay_s > 0:
            # Linger OUTSIDE the lock so arrivals can enqueue meanwhile.
            threading.Event().wait(self.max_delay_s)
        group, total = [], 0
        with self._cv:
            while self._queue:
                nxt = self._queue[0]
                if group and total + len(nxt.features) > self.max_batch:
                    break
                group.append(self._queue.pop(0))
                total += len(nxt.features)
            self._inflight = group  # visible to close() while we serve it
        return group

    def _run(self) -> None:
        while True:
            group = self._take_group()
            if group is None:
                return
            try:
                max_len = max(p.features.shape[1] for p in group)
                f = self.scorer.feature_size
                total = sum(len(p.features) for p in group)
                feats = np.zeros((total, max_len, f), np.float32)
                n_valid = np.zeros(total, np.int32)
                row = 0
                for p in group:
                    q, length, _ = p.features.shape
                    feats[row:row + q, :length] = p.features
                    n_valid[row:row + q] = p.n_valid
                    row += q
                scores, order = self.scorer._score_ranked(feats, n_valid)
                self.device_calls += 1
                row = 0
                for p in group:
                    q, length, _ = p.features.shape
                    p.scores = scores[row:row + q, :length]
                    # Ranked indices >= the request's own list length are
                    # group-padding; compact them out per row.
                    sub = order[row:row + q]
                    keep = sub < length
                    p.order = sub[keep].reshape(q, length)
                    row += q
            except Exception as exc:  # surface to every waiting caller
                for p in group:
                    p.error = exc
            finally:
                for p in group:
                    p.event.set()
                with self._cv:
                    self._inflight = []
