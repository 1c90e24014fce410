"""Ranker protocol and the building blocks the rankers share.

The port's counterpart of the JAX package's ``models/base.py``. A ranker
is an ``nn.Module`` mapping ``[B, L, F]`` features to ``[B, L]`` scores in
one call, so the whole batch goes through one ``[B*L, F]`` matmul chain.
Initialisation is torch's default ``nn.Linear`` uniform, drawn from an
explicit ``torch.Generator``; LayerNorm uses the JAX package's clamped
one-pass variance, not ``F.layer_norm``'s two-pass one, so the two
packages agree to float rounding.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ultra_pytorch_tpu_torch.utils.hparams import HParams

# Activation menu (the JAX package's ``models/base.py`` ACTIVATIONS).
ACTIVATIONS: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "elu": F.elu,
    "relu": F.relu,
    "selu": F.selu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
}

LN_EPS = 1e-5  # the one LayerNorm eps (shared with ops/kernels/mlp.py)


class BaseRanker(nn.Module):
    """A ranker owns parsed hparams and scores ``[B, L, F]`` -> ``[B, L]``."""

    def __init__(self, hparams_str: str = "", feature_size: int = 0):
        super().__init__()
        self.hparams = HParams(**self.default_hparams())
        self.hparams.parse(hparams_str or "")
        self.feature_size = feature_size

    def default_hparams(self) -> Dict[str, Any]:
        return {}

    def forward(self, features: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        raise NotImplementedError


def linear_init_(linear: nn.Linear,
                 generator: Optional[torch.Generator] = None) -> None:
    """torch's default ``nn.Linear`` init, U(-1/sqrt(fan_in), +), on
    `generator` (the global one when None). The values are drawn on the
    generator's device and copied, so a CPU generator gives the same
    weights to a ranker on any device."""
    bound = 1.0 / math.sqrt(linear.in_features)
    device = generator.device if generator is not None else None
    with torch.no_grad():
        for param in (linear.weight, linear.bias):
            param.copy_(torch.empty(param.shape, device=device).uniform_(
                -bound, bound, generator=generator))


def resolve_compute_dtype(name: str) -> Optional[torch.dtype]:
    return {"bfloat16": torch.bfloat16, "float16": torch.float16}.get(name)


def normalize_f32(x: torch.Tensor, eps: float = LN_EPS) -> torch.Tensor:
    """Pre-affine LayerNorm normalisation ``(x - mean) * rsqrt(var + eps)``
    with float32 statistics; returns float32. The variance is the clamped
    one-pass ``E[x^2] - E[x]^2`` of the JAX package, so the statistics
    match it to rounding."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = (x32 * x32).mean(-1, keepdim=True) - mean * mean
    return (x32 - mean) * torch.rsqrt(var.clamp_min(0.0) + eps)


class LayerNorm(nn.Module):
    """LayerNorm over the last axis: ``normalize_f32`` then the affine
    (``weight`` is the JAX ``scale``); output in the input's dtype."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = normalize_f32(x) * self.weight + self.bias
        return out.to(x.dtype)
