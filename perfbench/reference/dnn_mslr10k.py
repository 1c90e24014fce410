"""The DNN ranker of ULTRA (``ultra/ranking_model/DNN.py``), plain: for
each of the hidden widths and then a scalar output, LayerNorm (eps 1e-5,
over the layer's input), a Linear, and ELU on every layer but the last.
The tree is the port's checkpoint layout: ``{"layers": [{"linear": {"b",
"w" [in, out]}, "norm": {"bias", "scale"}}]}``."""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

EPS = 1e-5


def widths(cfg: Dict) -> List[int]:
    return ([cfg["features"]] + list(cfg["ranker_hparams"]
                                     ["hidden_layer_sizes"]) + [1])


def param_shapes(cfg: Dict) -> Dict:
    sizes = widths(cfg)
    return {"layers": [
        {"linear": {"w": ("uniform", (d_in, d_out), d_in),
                    "b": ("uniform", (d_out,), d_in)},
         "norm": {"scale": ("ones", (d_in,), d_in),
                  "bias": ("zeros", (d_in,), d_in)}}
        for d_in, d_out in zip(sizes[:-1], sizes[1:])]}


def forward(cfg: Dict, params: Dict, x: torch.Tensor,
            mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    layers = params["layers"]
    for j, layer in enumerate(layers):
        norm, linear = layer["norm"], layer["linear"]
        x = F.layer_norm(x, (x.shape[-1],), norm["scale"], norm["bias"], EPS)
        x = x @ linear["w"] + linear["b"]
        if j != len(layers) - 1:
            x = F.elu(x)
    return x.squeeze(-1)
