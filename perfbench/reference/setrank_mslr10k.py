"""The SetRank ranker of ULTRA (``ultra/ranking_model/SetRank.py``),
plain: LayerNorm of the features, an embedding FFN (F -> diff -> relu ->
d_model), ``num_layers`` encoder layers (multi-head self-attention over
the list with queries = keys = values = the layer's input split into
heads, softmax(q k^T / sqrt(depth)) with -1e9 on masked keys, the output
projection ``mha_dense``; then a post-norm residual; an FFN d_model ->
diff -> relu -> d_model and a second post-norm residual) and an output
FFN (d_model -> diff -> relu -> 1). Every LayerNorm has eps 1e-6. No
dropout (rate 0 at ULTRA's defaults). The tree is the port's checkpoint
layout."""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

EPS = 1e-6


def _linear(d_in: int, d_out: int) -> Dict:
    return {"w": ("uniform", (d_in, d_out), d_in),
            "b": ("uniform", (d_out,), d_in)}


def _norm(d: int) -> Dict:
    return {"scale": ("ones", (d,), d), "bias": ("zeros", (d,), d)}


def _ffn(d_in: int, dff: int, d_out: int) -> Dict:
    return {"fc1": _linear(d_in, dff), "fc2": _linear(dff, d_out)}


def param_shapes(cfg: Dict) -> Dict:
    hp = cfg["ranker_hparams"]
    f, d, dff = cfg["features"], hp["d_model"], hp["diff"]
    return {
        "input_norm": _norm(f),
        "input_embed": _ffn(f, dff, d),
        "layers": [{"mha_dense": _linear(d, d), "ffn": _ffn(d, dff, d),
                    "ln1": _norm(d), "ln2": _norm(d)}
                   for _ in range(hp["num_layers"])],
        "output": _ffn(d, dff, 1),
    }


def _apply_ffn(p: Dict, x: torch.Tensor) -> torch.Tensor:
    h = F.relu(x @ p["fc1"]["w"] + p["fc1"]["b"])
    return h @ p["fc2"]["w"] + p["fc2"]["b"]


def _norm_apply(p: Dict, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), p["scale"], p["bias"], EPS)


def forward(cfg: Dict, params: Dict, x: torch.Tensor,
            mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    B, L, _ = x.shape
    heads = cfg["ranker_hparams"]["num_heads"]
    x = _apply_ffn(params["input_embed"], _norm_apply(params["input_norm"],
                                                      x))
    d = x.shape[-1]
    depth = d // heads
    for layer in params["layers"]:
        q = x.reshape(B, L, heads, depth).transpose(1, 2)
        logits = q @ q.transpose(-1, -2) / math.sqrt(depth)
        if mask is not None:
            logits = logits + (1.0 - mask)[:, None, None, :] * -1e9
        attn = (torch.softmax(logits, dim=-1) @ q).transpose(1, 2).reshape(
            B, L, d)
        attn = attn @ layer["mha_dense"]["w"] + layer["mha_dense"]["b"]
        x = _norm_apply(layer["ln1"], x + attn)
        x = _norm_apply(layer["ln2"], x + _apply_ffn(layer["ffn"], x))
    return _apply_ffn(params["output"], x).squeeze(-1)
