"""SetRank: a permutation-invariant transformer-encoder scorer.

The port's counterpart of the JAX package's ``models/setrank.py``: input
LayerNorm -> FFN embedding (F -> dff -> relu -> d_model) -> N encoder
layers (multi-head self-attention over the candidate list, then an FFN,
each with a post-norm residual) -> FFN head (d_model -> dff -> relu -> 1).

* Attention takes q = k = v = x, split into heads, with no input
  projections and only the output projection ``mha_dense``; padded keys
  get -1e9 on their logits when a mask is given. The two products are
  ``torch.matmul`` (JAX computes them outside any Pallas kernel too).
* Every LayerNorm here uses eps 1e-6.
* Dropout (``rate``, default 0) at three sites: after the input embedding
  and after each layer's attention and FFN outputs, before the residual:
  ``1 + 2 * num_layers`` draws from the caller's generator, in that
  order, in training mode only.

Default hparams d_model=256, num_heads=8, num_layers=2, diff (dff)=64.
Params tree ``{"input_embed": {"fc1", "fc2"}, "input_norm", "layers":
[{"ffn": {"fc1", "fc2"}, "ln1", "ln2", "mha_dense"}], "output": {"fc1",
"fc2"}}``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ultra_pytorch_tpu_torch.models import base
from ultra_pytorch_tpu_torch.utils.registry import register

EPS = 1e-6


class FFN(nn.Module):
    """``fc2(relu(fc1(x)))``."""

    def __init__(self, d_in: int, dff: int, d_out: int):
        super().__init__()
        self.fc1 = nn.utils.skip_init(nn.Linear, d_in, dff)
        self.fc2 = nn.utils.skip_init(nn.Linear, dff, d_out)

    def jax_tree(self):
        return {"fc1": base.linear_tree(self.fc1),
                "fc2": base.linear_tree(self.fc2)}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.relu(self.fc1(x)))


class EncoderLayer(nn.Module):

    def __init__(self, d_model: int, dff: int):
        super().__init__()
        self.mha_dense = nn.utils.skip_init(nn.Linear, d_model, d_model)
        self.ffn = FFN(d_model, dff, d_model)
        self.ln1 = base.LayerNorm(d_model, EPS)
        self.ln2 = base.LayerNorm(d_model, EPS)

    def jax_tree(self):
        return {"ffn": self.ffn.jax_tree(), "ln1": base.norm_tree(self.ln1),
                "ln2": base.norm_tree(self.ln2),
                "mha_dense": base.linear_tree(self.mha_dense)}


@register("ranker", "SetRank", aliases=["ultra.ranking_model.SetRank"])
class SetRank(base.BaseRanker):

    def default_hparams(self):
        return {
            "d_model": 256,
            "num_heads": 8,
            "num_layers": 2,
            "diff": 64,        # dff; keeps the reference's hparam name
            "rate": 0.0,       # dropout rate at the three sites
        }

    def __init__(self, hparams_str: str = "", feature_size: int = 0,
                 generator: Optional[torch.Generator] = None):
        super().__init__(hparams_str, feature_size)
        hp = self.hparams
        d, dff = int(hp.d_model), int(hp.diff)
        self.input_norm = base.LayerNorm(feature_size, EPS)
        self.input_embed = FFN(feature_size, dff, d)
        self.layers = nn.ModuleList(EncoderLayer(d, dff)
                                    for _ in range(int(hp.num_layers)))
        self.output = FFN(d, dff, 1)
        self.reset_parameters(generator)

    def jax_tree(self):
        return {"input_embed": self.input_embed.jax_tree(),
                "input_norm": base.norm_tree(self.input_norm),
                "layers": [layer.jax_tree() for layer in self.layers],
                "output": self.output.jax_tree()}

    def _attention(self, layer: EncoderLayer, x: torch.Tensor,
                   attn_mask: Optional[torch.Tensor]) -> torch.Tensor:
        B, L, D = x.shape
        heads = int(self.hparams.num_heads)
        depth = D // heads
        q = x.reshape(B, L, heads, depth).transpose(1, 2)   # [B, H, L, d]
        logits = torch.matmul(q, q.transpose(-1, -2)) / math.sqrt(depth)
        if attn_mask is not None:
            logits = logits + attn_mask
        out = torch.matmul(torch.softmax(logits, dim=-1), q)
        return layer.mha_dense(out.transpose(1, 2).reshape(B, L, D))

    def forward(self, features: torch.Tensor,
                mask: Optional[torch.Tensor] = None, *,
                generator: Optional[torch.Generator] = None,
                training: bool = False) -> torch.Tensor:
        rate = float(self.hparams.rate)
        if training and rate > 0.0 and generator is None:
            raise ValueError(
                "SetRank rate>0 needs a training generator (pass generator= "
                "to the ranker; the algorithm layer passes the window's)")
        attn_mask = None
        if mask is not None:
            # [B, 1, 1, L]; the mask may be bool (the Scorer's).
            attn_mask = (1.0 - mask.to(features.dtype))[:, None, None, :] \
                * -1e9

        def drop(t):
            return base.dropout(generator, t, rate, training)

        x = drop(self.input_embed(self.input_norm(features)))
        for layer in self.layers:
            attn = drop(self._attention(layer, x, attn_mask))
            x = layer.ln1(x + attn)
            x = layer.ln2(x + drop(layer.ffn(x)))
        return self.output(x).squeeze(-1)
