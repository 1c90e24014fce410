"""DNN ranker: per-layer (LayerNorm -> Linear -> activation) MLP.

The port's counterpart of the JAX package's ``models/dnn.py``, with the
same hparams: ``hidden_layer_sizes=[512, 256, 128]`` plus the scalar
output layer, LayerNorm in front of every Linear, the activation (default
elu) on all but the last layer, ``fold_norm_affine``, ``compute_dtype``
(LayerNorm statistics stay in float32) and ``use_pallas``. The hparam
keeps its name so existing settings strings and checkpoints load
unchanged; here it selects the hand-written CUDA kernels
(``ops/kernels/mlp.py``): K1 for the forward and, when autograd needs
gradients, K2 for the backward from the residuals K1 then saves, as the
TPU's Pallas kernels split the work. Without
it the DNN trains through autograd of its plain path.

Weights cross from JAX through the generic bridge of ``models/base.py``
(:func:`params_from_jax` / :func:`params_to_jax` here are thin wrappers):
per layer ``linear{b, w}`` then ``norm{bias, scale}``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from ultra_pytorch_tpu_torch.models import base
from ultra_pytorch_tpu_torch.ops.kernels import mlp as mlp_kernel
from ultra_pytorch_tpu_torch.utils.registry import register


def _linear(x, w, b, cdtype):
    """``x @ w.T + b``; with a low-precision `cdtype` the product and the
    output are in that dtype (the JAX package's ``apply_linear``)."""
    if cdtype is None:
        return x @ w.t() + b
    return x.to(cdtype) @ w.to(cdtype).t() + b.to(cdtype)


@register("ranker", "DNN", aliases=["ultra.ranking_model.DNN"])
class DNN(base.BaseRanker):

    def default_hparams(self):
        return {
            "hidden_layer_sizes": [512, 256, 128],
            "activation_func": "elu",
            "norm": "layer",
            "compute_dtype": "float32",
            # Fold LayerNorm's affine (gamma, beta) into the next Linear:
            # (xhat*g + b) @ W == xhat @ (g[:,None]*W) + (b@W + bias).
            "fold_norm_affine": True,
            # The fused forward kernel (ops/kernels/mlp.py); on CPU
            # tensors it runs its plain PyTorch version.
            "use_pallas": False,
        }

    def __init__(self, hparams_str: str = "", feature_size: int = 0,
                 generator: Optional[torch.Generator] = None):
        super().__init__(hparams_str, feature_size)
        sizes = [feature_size] + list(self.hparams.hidden_layer_sizes) + [1]
        self.layers = nn.ModuleList(
            base.NormLinear(sizes[j], sizes[j + 1])
            for j in range(len(sizes) - 1))
        self.reset_parameters(generator)

    def jax_tree(self):
        return {"layers": [layer.jax_tree() for layer in self.layers]}

    def forward(self, features: torch.Tensor,
                mask: Optional[torch.Tensor] = None, *,
                generator: Optional[torch.Generator] = None,
                training: bool = False) -> torch.Tensor:
        use_norm = self.hparams.norm == "layer"
        if self.hparams.get("use_pallas"):
            return mlp_kernel.fused_mlp_score(
                self.layers, features,
                activation=self.hparams.activation_func, use_norm=use_norm)
        act = base.ACTIVATIONS[self.hparams.activation_func]
        cdtype = base.resolve_compute_dtype(
            self.hparams.get("compute_dtype", "float32"))
        fold = use_norm and self.hparams.get("fold_norm_affine", True)
        x = features if cdtype is None else features.to(cdtype)
        n_layers = len(self.layers)
        for j, layer in enumerate(self.layers):
            w, b = layer.linear.weight, layer.linear.bias
            if fold:
                g, b0 = layer.norm.weight, layer.norm.bias
                x = _linear(base.normalize_f32(x), w * g, b + w @ b0, cdtype)
            else:
                if use_norm:
                    x = layer.norm(x)
                x = _linear(x, w, b, cdtype)
            if j != n_layers - 1:
                x = act(x)
        return x.squeeze(-1).float()


def params_to_jax(model: DNN) -> Dict[str, Any]:
    """The model's weights as the JAX DNN's numpy params pytree
    ``{"layers": [{"linear": {"w" [in, out], "b"}, "norm": {"scale",
    "bias"}}]}``."""
    return base.params_to_jax(model)


def params_from_jax(model: DNN, params: Dict[str, Any]) -> DNN:
    """Load a JAX DNN params pytree (numpy or JAX arrays) into `model`."""
    return base.params_from_jax(model, params)
