"""Ranker protocol, the building blocks the rankers share, and the weight
bridge to the JAX package.

The port's counterpart of the JAX package's ``models/base.py``. A ranker
is an ``nn.Module`` mapping ``[B, L, F]`` features to ``[B, L]`` scores in
one call, so the whole batch goes through one ``[B*L, F]`` matmul chain.
``forward(features, mask, generator=None, training=False)`` is eval mode
unless the caller asks for training mode, where a ranker with dropout
(SetRank) draws its masks from `generator`, as the JAX ``apply`` takes
``rng`` and ``is_training``.

Initialisation is torch's default ``nn.Linear`` uniform, drawn from an
explicit ``torch.Generator``; LayerNorm uses the JAX package's clamped
one-pass variance, not ``F.layer_norm``'s two-pass one, so the two
packages agree to float rounding.

Each ranker declares :meth:`BaseRanker.jax_tree`, one nested dict that
mirrors its JAX params tree (the same key names) with leaves ``(tensor,
transposed)``: JAX stores a Linear's ``w`` as ``[in, out]`` and
``nn.Linear`` as ``[out, in]``. :meth:`BaseRanker.jax_leaves` flattens it
in ``jax.tree_util``'s order (dict keys sorted, lists in order), which is
the order of the optimizer's flat vector and of checkpoints, and
:func:`params_to_jax` / :func:`params_from_jax` carry weights across in
either direction.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
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

LN_EPS = 1e-5  # the default LayerNorm eps (shared with ops/kernels/mlp.py)

# A tensor in JAX's leaf order, and whether JAX stores it transposed.
Leaf = Tuple[torch.Tensor, bool]


class BaseRanker(nn.Module):
    """A ranker owns parsed hparams and scores ``[B, L, F]`` -> ``[B, L]``."""

    def __init__(self, hparams_str: str = "", feature_size: int = 0):
        super().__init__()
        self.hparams = HParams(**self.default_hparams())
        self.hparams.parse(hparams_str or "")
        self.feature_size = feature_size

    def default_hparams(self) -> Dict[str, Any]:
        return {}

    def reset_parameters(self, generator: Optional[torch.Generator] = None
                         ) -> None:
        """torch-default init of every Linear on `generator`; every
        LayerNorm to ones/zeros."""
        for module in self.modules():
            if isinstance(module, nn.Linear):
                linear_init_(module, generator)
            elif isinstance(module, LayerNorm):
                with torch.no_grad():
                    module.weight.fill_(1.0)
                    module.bias.zero_()

    def jax_tree(self) -> Dict[str, Any]:
        """The JAX params tree with ``(tensor, transposed)`` leaves."""
        raise NotImplementedError

    def jax_leaves(self) -> List[Leaf]:
        """``(tensor, transposed)`` in the JAX params tree's leaf order."""
        return _flatten(self.jax_tree())

    def forward(self, features: torch.Tensor,
                mask: Optional[torch.Tensor] = None, *,
                generator: Optional[torch.Generator] = None,
                training: bool = False) -> torch.Tensor:
        raise NotImplementedError


def linear_tree(linear: nn.Linear) -> Dict[str, Leaf]:
    """A Linear as the JAX ``{"b", "w" [in, out]}`` subtree."""
    return {"b": (linear.bias, False), "w": (linear.weight, True)}


def norm_tree(norm: "LayerNorm") -> Dict[str, Leaf]:
    """A LayerNorm as the JAX ``{"bias", "scale"}`` subtree."""
    return {"bias": (norm.bias, False), "scale": (norm.weight, False)}


def _is_leaf(node) -> bool:
    return isinstance(node, tuple) and isinstance(node[0], torch.Tensor)


def _flatten(tree) -> List[Leaf]:
    if _is_leaf(tree):
        return [tree]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _flatten(tree[k])]
    return [leaf for sub in tree for leaf in _flatten(sub)]


def params_to_jax(ranker: BaseRanker) -> Dict[str, Any]:
    """The ranker's weights as its JAX params tree of numpy arrays."""
    def convert(node):
        if _is_leaf(node):
            t, transposed = node
            return (t.t() if transposed else t).detach().cpu().numpy().copy()
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        return [convert(sub) for sub in node]

    return convert(ranker.jax_tree())


def params_from_jax(ranker: BaseRanker, params: Dict[str, Any]
                    ) -> BaseRanker:
    """Load a JAX params tree (numpy or JAX arrays) into `ranker`; the
    tree must have the ranker's structure and shapes."""
    def load(mine, theirs, path):
        if _is_leaf(mine):
            t, transposed = mine
            src = torch.as_tensor(np.array(theirs))
            if transposed:
                src = src.t()
            if tuple(src.shape) != tuple(t.shape):
                raise ValueError(f"param {path} shape {tuple(src.shape)} != "
                                 f"model shape {tuple(t.shape)}")
            t.copy_(src)
        elif isinstance(mine, dict):
            if sorted(mine) != sorted(theirs):
                raise ValueError(f"params keys {sorted(theirs)} at {path!r} "
                                 f"!= model keys {sorted(mine)}")
            for k in mine:
                load(mine[k], theirs[k], f"{path}/{k}")
        else:
            if len(mine) != len(theirs):
                raise ValueError(f"{len(theirs)} {path.rsplit('/', 1)[-1]} "
                                 f"in the params, {len(mine)} in the model")
            for i, (a, b) in enumerate(zip(mine, theirs)):
                load(a, b, f"{path}/{i}")

    with torch.no_grad():
        load(ranker.jax_tree(), params, "")
    return ranker


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

    def __init__(self, dim: int, eps: float = LN_EPS):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = normalize_f32(x, self.eps) * self.weight + self.bias
        return out.to(x.dtype)


class NormLinear(nn.Module):
    """One MLP layer's parameters: ``norm`` (LayerNorm) then ``linear``."""

    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.norm = LayerNorm(d_in)
        self.linear = nn.utils.skip_init(nn.Linear, d_in, d_out)

    def jax_tree(self) -> Dict[str, Any]:
        return {"linear": linear_tree(self.linear),
                "norm": norm_tree(self.norm)}


def dropout(generator: Optional[torch.Generator], x: torch.Tensor,
            rate: float, training: bool) -> torch.Tensor:
    """Inverted dropout (``nn.Dropout``'s semantics: scaled by
    ``1 / (1 - rate)`` in training, the identity in eval). The keep mask is
    one ``torch.rand`` of ``x``'s shape from `generator`; nothing is drawn
    at ``rate <= 0`` or in eval. ``rate > 0`` in training without a
    generator raises, as the JAX package's ``dropout`` does without an
    rng."""
    if not training or rate <= 0.0:
        return x
    if generator is None:
        raise ValueError(
            "dropout rate>0 in training mode requires a generator; pass one "
            "through ranker(..., generator=...) (see BaseAlgorithm."
            "score_with_params)")
    keep = torch.rand(x.shape, generator=generator,
                      device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


# -- DBGD-family noise utilities --------------------------------------------
# A noise is a list of tensors in the ranker's own layouts, one a
# ``jax_leaves()`` entry; a leading axis of size R holds R noises at once.

_NOISE_KEYS = ("linear", "out", "fc1", "fc2", "mha_dense", "input_embed",
               "output")
_FROZEN_KEYS = ("norm", "ln1", "ln2")


def _leaf_paths(tree, path=()) -> List[Tuple[str, ...]]:
    """The dict keys above each leaf, in ``_flatten``'s order."""
    if _is_leaf(tree):
        return [path]
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _leaf_paths(tree[k],
                                                             path + (k,))]
    return [p for sub in tree for p in _leaf_paths(sub, path)]


def noise_spec(ranker: BaseRanker) -> List[bool]:
    """Which ``jax_leaves()`` the DBGD family perturbs: those under a
    scorer's linear key, never a normalisation's (the JAX package's
    ``noise_spec``, by the same key names)."""
    spec = []
    for path in _leaf_paths(ranker.jax_tree()):
        frozen = any(k in _FROZEN_KEYS for k in path)
        spec.append(any(k in _NOISE_KEYS for k in path) and not frozen)
    return spec


def unit_noise(normals: List[torch.Tensor], ranker: BaseRanker
               ) -> List[torch.Tensor]:
    """The DBGD noise from given normals (each of its leaf's shape, with
    an optional leading axis): normalised along JAX's axis 0 (a Linear
    weight's ``in``, which is dim 1 of ``nn.Linear``'s ``[out, in]``; a
    bias as one vector), zero on the leaves the family does not perturb."""
    out = []
    for n, (t, transposed), noisy in zip(normals, ranker.jax_leaves(),
                                         noise_spec(ranker)):
        if not noisy:
            out.append(torch.zeros_like(n))
            continue
        dim = n.dim() - t.dim() + (1 if transposed else 0)
        norm = torch.linalg.vector_norm(n, dim=dim, keepdim=True)
        out.append(n / norm.clamp_min(1e-12))
    return out


def dbgd_noise_like(generator: torch.Generator, ranker: BaseRanker,
                    count: int = 1) -> List[torch.Tensor]:
    """`count` DBGD noises (a leading axis of that size on every leaf):
    N(0, 1) from `generator`, one ``torch.randn`` a perturbed leaf in
    leaf order, through :func:`unit_noise`."""
    normals = []
    for (t, _), noisy in zip(ranker.jax_leaves(), noise_spec(ranker)):
        shape = (count,) + tuple(t.shape)
        normals.append(torch.randn(shape, generator=generator,
                                   device=t.device)
                       if noisy else torch.empty(shape, device=t.device))
    return unit_noise(normals, ranker)


def sample_noise_like(generator: torch.Generator, ranker: BaseRanker,
                      normalize_per_leaf: bool = True) -> List[torch.Tensor]:
    """Gaussian noise of every leaf's shape, each leaf scaled to unit L2
    norm unless `normalize_per_leaf` is false."""
    noise = []
    for t, _ in ranker.jax_leaves():
        n = torch.randn(t.shape, generator=generator, device=t.device)
        if normalize_per_leaf:
            n = n / (torch.linalg.vector_norm(n) + 1e-12)
        noise.append(n)
    return noise


@torch.no_grad()
def perturb_(target: BaseRanker, base: BaseRanker,
             noise: List[torch.Tensor], rate: float) -> BaseRanker:
    """``target = base + rate * noise``, leaf for leaf, in place (`target`
    may be `base`); returns `target`."""
    dst = [t for t, _ in target.jax_leaves()]
    if target is not base:
        torch._foreach_copy_(dst, [t for t, _ in base.jax_leaves()])
    torch._foreach_add_(dst, list(noise), alpha=rate)
    return target
