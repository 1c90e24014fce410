"""GSF: Groupwise Scoring Function.

The port's counterpart of the JAX package's ``models/gsf.py`` (Ai et al.,
ICTIR '19): the documents of a group of ``group_size`` (m) are scored
jointly by an MLP over the concatenation of their features, and a
document's score is the mean of its scores over the m circular
sliding-window groups it belongs to.

* The groups: ``idx = (arange(L)[:, None] + arange(m)) % L``, so group g
  holds positions g, g + 1, ..., g + m - 1 mod L.
* The group net: per layer LayerNorm -> Linear -> activation, with no
  activation on the last layer, whose head is m wide (JAX runs it without
  the DNN's Pallas kernel, so it does not go through K1 here either).
* The scores go back to their documents with ``index_add_``: when L < m
  an index repeats within a group, and JAX's ``.at[].add`` accumulates the
  repeats, as ``index_add_`` does.

The mask is not used, as in the JAX package. Params tree
``{"input_norm": {...}, "layers": [{"linear": {"b", "w"}, "norm":
{"bias", "scale"}}]}``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ultra_pytorch_tpu_torch.models import base
from ultra_pytorch_tpu_torch.utils.registry import register


@register("ranker", "GSF", aliases=["ultra.ranking_model.GSF"])
class GSF(base.BaseRanker):

    def default_hparams(self):
        return {
            "group_size": 2,
            "hidden_layer_sizes": [256, 128],
            "activation_func": "elu",
            "norm": "layer",
        }

    def __init__(self, hparams_str: str = "", feature_size: int = 0,
                 generator: Optional[torch.Generator] = None):
        super().__init__(hparams_str, feature_size)
        m = int(self.hparams.group_size)
        sizes = ([feature_size * m] + list(self.hparams.hidden_layer_sizes)
                 + [m])
        self.input_norm = base.LayerNorm(feature_size)
        self.layers = nn.ModuleList(
            base.NormLinear(sizes[j], sizes[j + 1])
            for j in range(len(sizes) - 1))
        self.reset_parameters(generator)

    def jax_tree(self):
        return {"input_norm": base.norm_tree(self.input_norm),
                "layers": [layer.jax_tree() for layer in self.layers]}

    def forward(self, features: torch.Tensor,
                mask: Optional[torch.Tensor] = None, *,
                generator: Optional[torch.Generator] = None,
                training: bool = False) -> torch.Tensor:
        B, L, _ = features.shape
        m = int(self.hparams.group_size)
        use_norm = self.hparams.norm == "layer"
        act = base.ACTIVATIONS[self.hparams.activation_func]
        x = self.input_norm(features) if use_norm else features
        ar = torch.arange(L, device=features.device)
        idx = (ar[:, None] + torch.arange(m, device=features.device)) % L
        h = x[:, idx, :].reshape(B, L, -1)             # [B, L, m * F]
        for j, layer in enumerate(self.layers):
            if use_norm:
                h = layer.norm(h)
            h = layer.linear(h)
            if j != len(self.layers) - 1:
                h = act(h)
        # h[b, g, j] is the score of position idx[g, j] in group g.
        scores = torch.zeros((B, L), dtype=h.dtype, device=h.device)
        scores = scores.index_add(1, idx.reshape(-1), h.reshape(B, L * m))
        return scores / m
