"""Linear ranker: LayerNorm -> Linear(F, 1).

The port's counterpart of the JAX package's ``models/linear.py``: the
input LayerNorm (``norm=layer``, the default) then one scoring
projection over whole ``[B, L, F]`` lists. Params tree
``{"norm": {"bias", "scale"}, "out": {"b", "w"}}``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ultra_pytorch_tpu_torch.models import base
from ultra_pytorch_tpu_torch.utils.registry import register


@register("ranker", "Linear", aliases=["ultra.ranking_model.Linear"])
class Linear(base.BaseRanker):

    def default_hparams(self):
        return {"norm": "layer"}

    def __init__(self, hparams_str: str = "", feature_size: int = 0,
                 generator: Optional[torch.Generator] = None):
        super().__init__(hparams_str, feature_size)
        self.norm = base.LayerNorm(feature_size)
        self.out = nn.utils.skip_init(nn.Linear, feature_size, 1)
        self.reset_parameters(generator)

    def jax_tree(self):
        return {"norm": base.norm_tree(self.norm),
                "out": base.linear_tree(self.out)}

    def forward(self, features: torch.Tensor,
                mask: Optional[torch.Tensor] = None, *,
                generator: Optional[torch.Generator] = None,
                training: bool = False) -> torch.Tensor:
        x = features
        if self.hparams.norm == "layer":
            x = self.norm(x)
        return self.out(x).squeeze(-1)
