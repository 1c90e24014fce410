"""DLCM: Deep Listwise Context Model.

The port's counterpart of the JAX package's ``models/dlcm.py`` (Ai et
al., SIGIR '18): an input LayerNorm and projection ``tanh(embed(x))``, a
GRU that encodes the candidate list from the lowest position upward into
a context vector s, and the local ranking function
``phi(x_i, s) = v^T tanh(W_x x_i + W_s s + b)``.

The GRU is the JAX package's own, written out here: ``r * h`` is
concatenated with the input before the ``wh`` Linear (``torch.nn.GRU``
applies r after its hidden projection instead, a different function).
The list is flipped before encoding, and a padded step (mask 0) carries
the state through unchanged. The L steps are a Python loop of batched
``[B, E + H]`` products.

Params tree ``{"embed", "gru": {"wh", "wr", "wz"}, "input_norm", "phi_s",
"phi_v", "phi_x"}``, each Linear ``{"b", "w"}``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ultra_pytorch_tpu_torch.models import base
from ultra_pytorch_tpu_torch.utils.registry import register


class GRUCell(nn.Module):
    """The JAX package's GRU step: z and r from ``[x, h]``, the candidate
    from ``[x, r * h]``."""

    def __init__(self, in_dim: int, hidden: int):
        super().__init__()
        self.wz = nn.utils.skip_init(nn.Linear, in_dim + hidden, hidden)
        self.wr = nn.utils.skip_init(nn.Linear, in_dim + hidden, hidden)
        self.wh = nn.utils.skip_init(nn.Linear, in_dim + hidden, hidden)

    def jax_tree(self):
        return {k: base.linear_tree(getattr(self, k))
                for k in ("wh", "wr", "wz")}

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        hx = torch.cat([x, h], dim=-1)
        z = torch.sigmoid(self.wz(hx))
        r = torch.sigmoid(self.wr(hx))
        h_tilde = torch.tanh(self.wh(torch.cat([x, r * h], dim=-1)))
        return (1.0 - z) * h + z * h_tilde


@register("ranker", "DLCM", aliases=["ultra.ranking_model.DLCM"])
class DLCM(base.BaseRanker):

    def default_hparams(self):
        return {
            "embed_size": 64,     # input projection width
            "hidden_size": 64,    # GRU state width
            "norm": "layer",
        }

    def __init__(self, hparams_str: str = "", feature_size: int = 0,
                 generator: Optional[torch.Generator] = None):
        super().__init__(hparams_str, feature_size)
        E, H = int(self.hparams.embed_size), int(self.hparams.hidden_size)
        self.input_norm = base.LayerNorm(feature_size)
        self.embed = nn.utils.skip_init(nn.Linear, feature_size, E)
        self.gru = GRUCell(E, H)
        self.phi_x = nn.utils.skip_init(nn.Linear, E, H)
        self.phi_s = nn.utils.skip_init(nn.Linear, H, H)
        self.phi_v = nn.utils.skip_init(nn.Linear, H, 1)
        self.reset_parameters(generator)

    def jax_tree(self):
        return {"embed": base.linear_tree(self.embed),
                "gru": self.gru.jax_tree(),
                "input_norm": base.norm_tree(self.input_norm),
                "phi_s": base.linear_tree(self.phi_s),
                "phi_v": base.linear_tree(self.phi_v),
                "phi_x": base.linear_tree(self.phi_x)}

    def forward(self, features: torch.Tensor,
                mask: Optional[torch.Tensor] = None, *,
                generator: Optional[torch.Generator] = None,
                training: bool = False) -> torch.Tensor:
        B, L, _ = features.shape
        x = features
        if self.hparams.norm == "layer":
            x = self.input_norm(x)
        x = torch.tanh(self.embed(x))                        # [B, L, E]
        xs = torch.flip(x, dims=[1])
        ms = None if mask is None else torch.flip(mask, dims=[1]) > 0
        h = x.new_zeros((B, int(self.hparams.hidden_size)))
        for t in range(L):
            h_new = self.gru(h, xs[:, t])
            h = h_new if ms is None else torch.where(ms[:, t, None], h_new, h)
        hidden = torch.tanh(self.phi_x(x) + self.phi_s(h)[:, None, :])
        return self.phi_v(hidden).squeeze(-1)
