"""Batched ranking samplers.

The port's counterpart of the JAX package's ``sim/sampling.py``:
Plackett-Luce rankings by Gumbel-top-k (one batched argsort draws from
the same distribution as sampling without replacement from
``softmax(tau * scores)``), the deterministic descending rank, and the
gather into ranked order. Draws come from an explicit ``torch.Generator``
on the scores' device.

Both sorts are stable, as ``jnp.argsort`` is by default: padded documents
get ``-1e9 - j``, and float32's spacing at 1e9 is 64, so pads tie with one
another and only a stable sort keeps them in index order.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e9


def plackett_luce_sample(generator: Optional[torch.Generator],
                         scores: torch.Tensor,
                         mask: Optional[torch.Tensor] = None,
                         tau: float = 1.0) -> torch.Tensor:
    """Rankings ``[B, L]`` (int64: position j holds the index of the
    document ranked j-th) drawn from PL(softmax(tau * scores)). Documents
    with ``mask == 0`` come after every valid one, in index order."""
    u = torch.rand(scores.shape, generator=generator, device=scores.device)
    keys = tau * scores - torch.log(-torch.log(u.clamp_min_(1e-20)))
    if mask is not None:
        tie_break = -torch.arange(scores.shape[1], dtype=scores.dtype,
                                  device=scores.device)
        keys = torch.where(mask > 0, keys, NEG_INF + tie_break)
    return torch.argsort(-keys, dim=1, stable=True)


def deterministic_rank(scores: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Rank by score descending (stable), documents with ``mask == 0``
    last."""
    keys = scores
    if mask is not None:
        keys = torch.where(mask > 0, scores, torch.full_like(scores, NEG_INF))
    return torch.argsort(-keys, dim=1, stable=True)


def rerank(values: torch.Tensor, ranking: torch.Tensor) -> torch.Tensor:
    """``values [B, L]`` gathered into ranked order by ``ranking [B, L]``."""
    return torch.gather(values, 1, ranking.long())
