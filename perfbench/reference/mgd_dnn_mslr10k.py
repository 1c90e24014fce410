"""The DNN ranker of ``dnn_mslr10k`` (``reference/dnn_mslr10k.py``: its
tree and forward) and the noise ULTRA's DBGD family draws for it
(``ultra/learning_algorithm/dbgd.py``, ``create_noisy_param``): for each
Linear, in the tree's leaf order, one standard normal draw of its weight
in ``nn.Linear``'s ``[out, in]`` layout, each output unit's row scaled to
unit norm, and one of its bias, scaled as a whole; LayerNorm's scale and
bias are never perturbed. The training step is ``yardstick/mgd.py``."""

from __future__ import annotations

from typing import Dict, List

import torch

from perfbench.reference.dnn_mslr10k import forward, param_shapes  # noqa: F401
from perfbench.yardstick.trees import flatten


def _unit(n: torch.Tensor) -> torch.Tensor:
    return n / torch.linalg.vector_norm(n, dim=-1,
                                        keepdim=True).clamp_min(1e-12)


def noise(params: Dict, count: int, generator: torch.Generator
          ) -> List[torch.Tensor]:
    """`count` noises of every leaf of `params`, in leaf order, each with
    a leading axis of `count` and in the leaf's layout (a weight's ``[in,
    out]``); zeros, and no draw, for a leaf that is not perturbed."""
    out = []
    for path, leaf in flatten(params):
        shape = (count,) + tuple(leaf.shape)
        if path.endswith("/linear/w"):
            drawn = torch.randn((count,) + tuple(leaf.shape[::-1]),
                                generator=generator, device=leaf.device)
            out.append(_unit(drawn).transpose(1, 2))
        elif path.endswith("/linear/b"):
            out.append(_unit(torch.randn(shape, generator=generator,
                                         device=leaf.device)))
        else:
            out.append(torch.zeros(shape, device=leaf.device))
    return out
