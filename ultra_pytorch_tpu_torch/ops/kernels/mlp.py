"""K1: the DNN ranker's fused MLP forward, a CUDA kernel for Hopper.

Port of the TPU kernel ``_kernel`` of ``ultra_pytorch_tpu/ops/pallas/mlp.py``
(entry ``fused_mlp_score``). The kernel (``csrc/mlp_fwd.cu``) scores every
row of ``[N, F]`` features through the whole layer chain, LayerNorm ->
Linear -> activation per layer, keeping each row tile's activations in
shared memory. :func:`fused_mlp_score` keeps the JAX signature:

* on a CPU tensor it runs :func:`fused_mlp_score_reference`, the plain
  PyTorch version of the same arithmetic (clamped one-pass variance);
* on a CUDA tensor it launches the kernel or raises. Nothing falls back.

The kernel has no backward yet (K2, the fused MLP backward, comes with
training): on CUDA, a call that autograd would have to differentiate
raises ``NotImplementedError``. Serving runs under ``inference_mode``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch
from torch import nn

from ultra_pytorch_tpu_torch.models.base import ACTIVATIONS, normalize_f32
from ultra_pytorch_tpu_torch.ops.kernels import build

# The kernel's activation codes (``activate`` in csrc/mlp_fwd.cu).
ACTIVATION_CODES = {"elu": 0, "relu": 1, "selu": 2, "tanh": 3, "sigmoid": 4}
SMEM_LIMIT = 232_448  # dynamic shared memory one Hopper block can have
SOURCE = build.CSRC_DIR / "mlp_fwd.cu"


def _layer_params(layers) -> Sequence[Tuple[torch.Tensor, ...]]:
    return [(layer.norm.weight, layer.norm.bias,
             layer.linear.weight, layer.linear.bias) for layer in layers]


def _widths(layers) -> Tuple[int, ...]:
    return (layers[0].linear.in_features,) + tuple(
        layer.linear.out_features for layer in layers)


def fused_mlp_score_reference(layers, features: torch.Tensor,
                              activation: str = "elu",
                              use_norm: bool = True) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the JAX ``_layer_chain``."""
    act = ACTIVATIONS[activation]
    h = features.reshape(-1, features.shape[-1])
    n_layers = len(layers)
    for j, (scale, bias, w, b) in enumerate(_layer_params(layers)):
        if use_norm:
            h = normalize_f32(h) * scale + bias
        h = h @ w.t() + b
        if j != n_layers - 1:
            h = act(h)
    return h[:, 0].reshape(features.shape[:-1])


@functools.lru_cache(maxsize=None)
def _library():
    built = build.build_library("mlp_fwd", [SOURCE])
    lib = ctypes.CDLL(str(built.path))
    lib.ultra_mlp_fwd.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    lib.ultra_mlp_fwd.restype = ctypes.c_int
    lib.ultra_mlp_fwd_smem_bytes.argtypes = [
        ctypes.POINTER(ctypes.c_int), ctypes.c_int]
    lib.ultra_mlp_fwd_smem_bytes.restype = ctypes.c_longlong
    lib.ultra_mlp_fwd_max_layers.argtypes = []
    lib.ultra_mlp_fwd_max_layers.restype = ctypes.c_int
    lib.ultra_cuda_error_string.argtypes = [ctypes.c_int]
    lib.ultra_cuda_error_string.restype = ctypes.c_char_p
    return lib, built


def build_kernel() -> build.BuiltLibrary:
    """Build (once per process) and load K1; returns the build record."""
    return _library()[1]


def _packed(layers: nn.ModuleList) -> torch.Tensor:
    """The parameters as one contiguous buffer, per layer ``[scale, bias,
    W as [in, out], b]``, the layout the kernel reads. Cached on `layers`
    until a parameter changes (another tensor or an in-place update).
    Inference tensors keep no version counter, so parameters created
    under ``inference_mode`` are packed anew on every call."""
    params = [p for group in _layer_params(layers) for p in group]
    cacheable = not any(p.is_inference() for p in params)
    key = cacheable and tuple((p.data_ptr(), p._version) for p in params)
    cached = getattr(layers, "_k1_packed", None)
    if cacheable and cached is not None and cached[0] == key:
        return cached[1]
    with torch.no_grad():
        buf = torch.cat([t.detach().float().reshape(-1) for scale, bias, w, b
                         in _layer_params(layers)
                         for t in (scale, bias, w.t(), b)]).contiguous()
    if cacheable:
        layers._k1_packed = (key, buf)
    return buf


def fused_mlp_score(layers, features: torch.Tensor, activation: str = "elu",
                    use_norm: bool = True) -> torch.Tensor:
    """Score ``[B, L, F]`` (or ``[N, F]``) float32 features with K1.

    `layers` is the DNN's ``layers`` (each with ``norm`` and ``linear``).
    Returns ``[B, L]`` (or ``[N]``) float32 scores.
    """
    if activation not in ACTIVATION_CODES:
        raise ValueError(f"unknown activation {activation!r}")
    widths = _widths(layers)
    if features.shape[-1] != widths[0] or widths[-1] != 1:
        raise ValueError(f"features [..., {features.shape[-1]}] do not fit "
                         f"the layer widths {list(widths)}")
    if features.dtype != torch.float32:
        raise TypeError(f"features must be float32, got {features.dtype}")
    if features.device.type == "cpu":
        return fused_mlp_score_reference(layers, features, activation,
                                         use_norm)
    if features.device.type != "cuda":
        raise ValueError(f"no K1 kernel for device {features.device}")
    return _launch(layers, features, widths, activation, use_norm)


fused_mlp_score.launches = 0  # kernel launches, for run-time evidence


def _launch(layers, features, widths, activation, use_norm):
    x = features.reshape(-1, widths[0])
    if not x.is_contiguous():
        raise ValueError("features must be contiguous")
    if torch.is_grad_enabled() and (features.requires_grad or any(
            p.requires_grad for group in _layer_params(layers)
            for p in group)):
        raise NotImplementedError(
            "K2 (fused MLP backward) is not yet ported: call the CUDA "
            "forward under torch.inference_mode() or torch.no_grad()")
    lib, _ = _library()
    n_layers = len(layers)
    c_widths = (ctypes.c_int * len(widths))(*widths)
    if n_layers > lib.ultra_mlp_fwd_max_layers():
        raise ValueError(f"{n_layers} layers exceed the kernel's "
                         f"{lib.ultra_mlp_fwd_max_layers()}")
    smem = lib.ultra_mlp_fwd_smem_bytes(c_widths, n_layers)
    if smem > SMEM_LIMIT:
        raise ValueError(f"widths {list(widths)} need {smem} B of shared "
                         f"memory, more than the {SMEM_LIMIT} B a block has")
    params = _packed(layers)
    if params.device != x.device:
        raise ValueError(f"parameters on {params.device}, features on "
                         f"{x.device}")
    out = torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
    if x.shape[0]:
        with torch.cuda.device(x.device):
            err = lib.ultra_mlp_fwd(
                x.data_ptr(), params.data_ptr(), out.data_ptr(), x.shape[0],
                c_widths, n_layers, ACTIVATION_CODES[activation],
                int(use_norm), torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(
                f"K1 launch failed: {lib.ultra_cuda_error_string(err)} "
                f"(CUDA error {err})")
        fused_mlp_score.launches += 1
    return out.reshape(features.shape[:-1])
