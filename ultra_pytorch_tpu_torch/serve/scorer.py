"""Checkpoint-loading batched scorer for online inference.

The port's counterpart of the JAX package's ``serve/scorer.py``:

* **Shape buckets.** Requests are padded to power-of-two (batch, list)
  buckets, as on the TPU, and padding invariance is part of the contract
  the tests hold. ``bucket_calls`` records the calls per bucket.
* **One program per bucket.** ``_ranked_fn(bq, bl)`` is the counterpart
  of the JAX scorer's jitted ``_ranked_fn``: the ranker's forward in eval
  mode, the mask built on the device from the lists' lengths, the
  ``-1e30`` fill and the stable descending argsort. On CUDA it is one
  captured CUDA graph a bucket (``run/window.capture``, all buckets in
  one memory pool), replayed; on the CPU the same body runs eagerly.
  ``warmup`` captures every bucket up to its maxima before the first
  request, as JAX's compiles them.
* **Static buffers.** A request is staged into one host buffer (pinned on
  CUDA) the size of the largest bucket seen, each bucket a contiguous view
  from its start; the staging first zeroes what the previous request
  wrote, so a bucket reused by a smaller request sees zeros where JAX
  pads with zeros (GSF ignores the mask: its scores read padded
  positions). One copy in, the replay, two copies out into pinned
  buffers, one stream sync. A lock serialises calls: the HTTP server's
  threads may call the scorer directly.
* **Checkpoints carry their schema.** The JAX trainer embeds the ranker
  name, its hparams and the feature size in the checkpoint metadata, so
  ``Scorer.from_checkpoint(model_dir)`` needs no settings file. Only the
  ranker params are read: they are the first leaves of the file.
* **Any registered ranker serves.** Its weights come through the generic
  bridge of ``models/base.py`` (``params_to_jax`` gives the template,
  ``params_from_jax`` loads it).
* **The DNN runs K1 on CUDA.** ``use_pallas=None`` turns the fused forward
  kernel on for the DNN on a CUDA device, as the JAX scorer turns the
  Pallas kernel on for the DNN on a TPU. K1 is the DNN's alone: forcing it
  for another ranker raises.
"""

from __future__ import annotations

import glob
import os
import threading
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ultra_pytorch_tpu_torch.models.base import params_from_jax, params_to_jax
from ultra_pytorch_tpu_torch.run.window import capture
from ultra_pytorch_tpu_torch.utils import checkpoint as ckpt_lib
from ultra_pytorch_tpu_torch.utils.device import resolve_device
from ultra_pytorch_tpu_torch.utils.registry import find_class

_NEG_INF = -1e30


def _bucket(n: int, floor: int) -> int:
    """Smallest power-of-two >= n (at least `floor`)."""
    b = floor
    while b < n:
        b *= 2
    return b


def _find_ckpt(path: str) -> str:
    """Resolve a model dir or ckpt path to the ``<path>.ckpt`` stem."""
    if path.endswith(".ckpt"):
        return path
    if path.endswith(".ckpt.npz"):
        return path[: -len(".npz")]
    hits = sorted(glob.glob(os.path.join(path, "*.ckpt.npz")))
    if not hits:
        raise FileNotFoundError(f"no *.ckpt.npz checkpoint under {path}")
    if len(hits) > 1:
        raise ValueError(
            f"multiple checkpoints under {path}: {hits}; pass the .ckpt")
    return hits[0][: -len(".npz")]


class Scorer:
    """Batched ranking inference over a trained ranker."""

    def __init__(self, ranker: torch.nn.Module, feature_size: int,
                 device=None, min_batch_bucket: int = 8,
                 min_list_bucket: int = 8, graphs: Optional[bool] = None):
        """`graphs`: each bucket a captured CUDA graph (None = auto: on
        CUDA); False runs the same body eagerly."""
        self.device = resolve_device(device)
        self.ranker = ranker.to(self.device).eval()
        self.feature_size = int(feature_size)
        self.min_batch_bucket = min_batch_bucket
        self.min_list_bucket = min_list_bucket
        cuda = self.device.type == "cuda"
        if graphs and not cuda:
            raise ValueError("CUDA graphs need a CUDA device")
        self.graphs = cuda if graphs is None else graphs
        self.bucket_calls: Dict[Tuple[int, int], int] = {}
        self._lock = threading.Lock()
        self._rows = 0            # the buffers' capacity in bucket rows
        self._ranked: Dict[Tuple[int, int], Callable] = {}
        self._last = None         # the extent the last request staged

    # -- construction -----------------------------------------------------
    @classmethod
    def from_checkpoint(cls, path: str,
                        exp_settings: Optional[Dict[str, Any]] = None,
                        feature_size: Optional[int] = None,
                        use_pallas: Optional[bool] = None,
                        device=None, **kwargs) -> "Scorer":
        """Load a checkpoint (written by the JAX trainer or by the port).

        Args:
          path: model dir, ``<algo>.ckpt`` stem, or ``.ckpt.npz`` file.
          exp_settings: experiment-settings dict; overrides the embedded
            settings (needed only for checkpoints without them).
          feature_size: fallback when the metadata lacks it.
          use_pallas: run the DNN through K1, the fused forward kernel.
            None = auto: on for the DNN on CUDA, off elsewhere. Forcing it
            for another ranker raises.
          device: torch device; None means ``"cuda"`` and raises without
            a card.
        """
        device = resolve_device(device)
        ckpt = _find_ckpt(path)
        serve_meta = ckpt_lib.read_metadata(ckpt).get("serve", {})
        settings = dict(serve_meta.get("exp_settings", {}))
        settings.update(exp_settings or {})
        if feature_size is None:
            feature_size = serve_meta.get("feature_size")
        if feature_size is None:
            raise ValueError(
                f"{ckpt} predates serve metadata; pass feature_size= and "
                "exp_settings= explicitly")
        if "ranking_model" not in settings:
            raise ValueError(
                "cannot rebuild the ranker: 'ranking_model' neither "
                f"embedded in {ckpt} metadata nor passed via exp_settings")
        is_dnn = settings["ranking_model"].rsplit(".", 1)[-1] == "DNN"
        if use_pallas is None:
            use_pallas = is_dnn and device.type == "cuda"
        if use_pallas and not is_dnn:
            raise ValueError("use_pallas serving requires the DNN "
                             f"ranker, got {settings['ranking_model']}")
        hp = settings.get("ranking_model_hparams", "")
        if is_dnn:
            hp = (hp + "," if hp else "") + f"use_pallas={bool(use_pallas)}"

        ranker_cls = find_class(settings["ranking_model"], kind="ranker")
        ranker = ranker_cls(hp, int(feature_size))
        params = ckpt_lib.load_params_prefix(ckpt, params_to_jax(ranker))
        params_from_jax(ranker, params)
        return cls(ranker, int(feature_size), device=device, **kwargs)

    # -- inference --------------------------------------------------------
    def _reserve(self, rows: int) -> None:
        """Buffers for buckets of up to `rows` rows (batch x list). Growing
        them drops every bucket's program, which read the old ones."""
        if rows <= self._rows:
            return
        f, pin = self.feature_size, self.device.type == "cuda"
        max_batch = rows // self.min_list_bucket
        self._x = torch.zeros(rows * f, device=self.device)
        self._n = torch.zeros(max_batch, dtype=torch.int32,
                              device=self.device)
        self._x_host = torch.zeros(rows * f, pin_memory=pin)
        self._n_host = torch.zeros(max_batch, dtype=torch.int32,
                                   pin_memory=pin)
        self._scores_host = torch.empty(rows, pin_memory=pin)
        self._order_host = torch.empty(rows, dtype=torch.int64,
                                       pin_memory=pin)
        self._pool = torch.cuda.graph_pool_handle() if self.graphs else None
        self._rows, self._ranked, self._last = rows, {}, None

    def _body(self, bq: int, bl: int):
        """Bucket (bq, bl)'s scoring on the staged buffers: the masked
        scores and the ranked indices, ``[bq, bl]`` each."""
        x = self._x[:bq * bl * self.feature_size].view(
            bq, bl, self.feature_size)
        mask = (torch.arange(bl, device=self.device)[None, :]
                < self._n[:bq, None])
        scores = self.ranker(x, mask)
        masked = torch.where(mask, scores, torch.full_like(scores, _NEG_INF))
        return masked, torch.argsort(-masked, dim=1, stable=True)

    def _ranked_fn(self, bq: int, bl: int) -> Callable:
        """Bucket (bq, bl)'s program, made at its first call: a function of
        no arguments that scores what is staged and returns the masked
        scores and the ranked indices. On CUDA it replays the bucket's
        graph (a ``run/window.Replayable``, which adds K1's launch to the
        spans' counters at each replay); on the CPU, or with
        ``graphs=False``, it runs the body eagerly."""
        key = (bq, bl)
        if key not in self._ranked:
            self._reserve(bq * bl)
            if self.graphs:
                with torch.inference_mode():
                    graph, out = capture(lambda: self._body(bq, bl),
                                         pool=self._pool,
                                         name=f"serve.{bq}x{bl}")

                def ranked():
                    graph.replay()
                    return out
            else:
                def ranked():
                    return self._body(bq, bl)
            self._ranked[key] = ranked
        return self._ranked[key]

    def _stage(self, features: np.ndarray, n_valid: np.ndarray,
               bq: int, bl: int) -> None:
        """Write the request into the host buffers in bucket (bq, bl)'s
        layout after zeroing the previous request's extent, so everything
        outside this request is zero."""
        f = self.feature_size
        host = self._x_host.numpy()
        if self._last is not None:
            pq, pl, q0, l0 = self._last
            host[:pq * pl * f].reshape(pq, pl, f)[:q0, :l0] = 0.0
        q, length, _ = features.shape
        host[:bq * bl * f].reshape(bq, bl, f)[:q, :length] = features
        n = self._n_host.numpy()
        n[:bq] = 0
        n[:q] = n_valid
        self._last = (bq, bl, q, length)

    def score(self, features: np.ndarray,
              n_valid: Optional[Sequence[int]] = None) -> np.ndarray:
        """Scores for ``[Q, L, F]`` candidate lists -> ``[Q, L]`` float32.

        Positions beyond each query's ``n_valid`` get ``-1e30``.
        """
        scores, _ = self._score_ranked(features, n_valid)
        return scores

    def rank(self, features: np.ndarray,
             n_valid: Optional[Sequence[int]] = None) -> np.ndarray:
        """Ranked candidate indices (best first) for each query ``[Q, L]``.

        Invalid (padded) positions sort to the tail.
        """
        _, order = self._score_ranked(features, n_valid)
        return order

    def _score_ranked(self, features, n_valid):
        features = np.asarray(features, np.float32)
        if features.ndim == 2:
            features = features[None]
        q, length, f = features.shape
        if f != self.feature_size:
            raise ValueError(
                f"feature size {f} != model feature size {self.feature_size}")
        n_valid = (np.full(q, length, np.int32) if n_valid is None
                   else np.asarray(n_valid, np.int32))
        bq = _bucket(q, self.min_batch_bucket)
        bl = _bucket(length, self.min_list_bucket)
        rows = bq * bl
        with self._lock:
            ranked = self._ranked_fn(bq, bl)
            self._stage(features, n_valid, bq, bl)
            self._x[:rows * f].copy_(self._x_host[:rows * f],
                                     non_blocking=True)
            self._n[:bq].copy_(self._n_host[:bq], non_blocking=True)
            with torch.inference_mode():
                masked, order = ranked()
            self._scores_host[:rows].view(bq, bl).copy_(masked,
                                                        non_blocking=True)
            self._order_host[:rows].view(bq, bl).copy_(order,
                                                       non_blocking=True)
            if self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()
            scores = self._scores_host[:rows].view(bq, bl).numpy()[
                :q, :length].copy()
            order = self._order_host[:rows].view(bq, bl).numpy()[:q].copy()
            self.bucket_calls[(bq, bl)] = self.bucket_calls.get(
                (bq, bl), 0) + 1
        # Keep only in-range candidate indices per query, in ranked order.
        keep = order < length
        order = order[keep].reshape(q, length)
        return scores, order

    def warmup(self, max_batch: int, max_list_size: int) -> None:
        """Run every bucket up to the given maxima once: the buffers take
        the largest bucket's size, and on CUDA each bucket's graph is
        captured (the kernel and the library handles built) before the
        first request."""
        self._reserve(_bucket(max_batch, self.min_batch_bucket)
                      * _bucket(max_list_size, self.min_list_bucket))
        b = self.min_batch_bucket
        while True:
            li = self.min_list_bucket
            while True:
                feats = np.zeros((b, li, self.feature_size), np.float32)
                self.score(feats)
                if li >= max_list_size:
                    break
                li *= 2
            if b >= max_batch:
                break
            b *= 2
