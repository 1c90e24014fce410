"""Checkpoint-loading batched scorer for online inference.

The port's counterpart of the JAX package's ``serve/scorer.py``:

* **Shape buckets.** Requests are padded to power-of-two (batch, list)
  buckets, as on the TPU. Eager PyTorch compiles nothing per shape, but the
  buckets keep the kernel's launch shapes, and so its timings, to a small
  known set, and padding invariance is part of the contract the tests
  hold. ``bucket_calls`` records the calls per bucket.
* **One device call per request.** Scoring, pad masking (``-1e30``) and
  the stable descending argsort run on the device under
  ``torch.inference_mode()``; only scores and ranked indices come back.
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
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ultra_pytorch_tpu_torch.models.base import params_from_jax, params_to_jax
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
                 min_list_bucket: int = 8):
        self.device = resolve_device(device)
        self.ranker = ranker.to(self.device).eval()
        self.feature_size = int(feature_size)
        self.min_batch_bucket = min_batch_bucket
        self.min_list_bucket = min_list_bucket
        self.bucket_calls: Dict[Tuple[int, int], int] = {}

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
    def _pad(self, features: np.ndarray, n_valid: np.ndarray):
        q, length, f = features.shape
        if f != self.feature_size:
            raise ValueError(
                f"feature size {f} != model feature size {self.feature_size}")
        bq = _bucket(q, self.min_batch_bucket)
        bl = _bucket(length, self.min_list_bucket)
        padded = np.zeros((bq, bl, f), np.float32)
        padded[:q, :length] = features
        mask = (np.arange(bl)[None, :]
                < np.concatenate([n_valid, np.zeros(bq - q)])[:, None])
        return padded, mask

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
        q, length, _ = features.shape
        n_valid = (np.full(q, length, np.int32) if n_valid is None
                   else np.asarray(n_valid, np.int32))
        padded, mask = self._pad(features, n_valid)
        with torch.inference_mode():
            x = torch.from_numpy(padded).to(self.device)
            m = torch.from_numpy(mask).to(self.device)
            scores = self.ranker(x, m)
            masked = torch.where(m, scores, torch.full_like(scores, _NEG_INF))
            order = torch.argsort(-masked, dim=1, stable=True)
            masked, order = masked.cpu().numpy(), order.cpu().numpy()
        bucket = padded.shape[:2]
        self.bucket_calls[bucket] = self.bucket_calls.get(bucket, 0) + 1
        scores = masked[:q, :length]
        order = order[:q]
        # Keep only in-range candidate indices per query, in ranked order.
        keep = order < length
        order = order[keep].reshape(q, length)
        return scores, order

    def warmup(self, max_batch: int, max_list_size: int) -> None:
        """Run every bucket up to the given maxima once (builds the kernel
        and the library handles before the first request)."""
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
