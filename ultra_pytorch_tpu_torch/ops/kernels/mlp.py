"""K1 and K2: the DNN ranker's fused MLP forward and backward, CUDA
kernels for Hopper.

Port of the TPU kernels ``_kernel`` (K1) and ``_bwd_kernel`` (K2) of
``ultra_pytorch_tpu/ops/pallas/mlp.py`` (entry ``fused_mlp_score``, a
``jax.custom_vjp``). K1 (``csrc/mlp_fwd.cu``) scores every row of ``[N, F]``
features through the whole layer chain, LayerNorm -> Linear -> activation
per layer, keeping each row tile's activations in shared memory. K2
(``csrc/mlp_bwd.cu``) recomputes that forward per row tile and
backpropagates through it, in two deterministic phases.

:func:`fused_mlp_score` keeps the JAX signature and is differentiable: it
applies :class:`FusedMLP`, a ``torch.autograd.Function`` whose forward is
:func:`mlp_forward` (K1) and whose backward is :func:`mlp_backward` (K2).
Each of those two wrappers

* on a CPU tensor runs its plain PyTorch version
  (:func:`fused_mlp_score_reference`, and autograd through it);
* on a CUDA tensor launches its kernel or raises. Nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Sequence, Tuple

import torch
from torch import nn

from ultra_pytorch_tpu_torch.models.base import ACTIVATIONS, normalize_f32
from ultra_pytorch_tpu_torch.ops.kernels import build

# The kernels' activation codes (``activate`` in csrc/mlp_fwd.cu and
# csrc/mlp_bwd.cu).
ACTIVATION_CODES = {"elu": 0, "relu": 1, "selu": 2, "tanh": 3, "sigmoid": 4}
SMEM_LIMIT = 232_448  # dynamic shared memory one Hopper block can have
SOURCE = build.CSRC_DIR / "mlp_fwd.cu"
BWD_SOURCE = build.CSRC_DIR / "mlp_bwd.cu"


def _layer_params(layers) -> Sequence[Tuple[torch.Tensor, ...]]:
    return [(layer.norm.weight, layer.norm.bias,
             layer.linear.weight, layer.linear.bias) for layer in layers]


def _flat_params(layers) -> List[torch.Tensor]:
    return [p for group in _layer_params(layers) for p in group]


def _widths(layers) -> Tuple[int, ...]:
    return (layers[0].linear.in_features,) + tuple(
        layer.linear.out_features for layer in layers)


def _chain(h: torch.Tensor, params: Sequence[torch.Tensor], activation: str,
           use_norm: bool) -> torch.Tensor:
    """The JAX ``_layer_chain`` on ``[N, F]`` rows; `params` is the flat
    per-layer ``(scale, bias, weight [out, in], b)`` list. Returns ``[N]``."""
    act = ACTIVATIONS[activation]
    n_layers = len(params) // 4
    for j in range(n_layers):
        scale, bias, w, b = params[4 * j: 4 * j + 4]
        if use_norm:
            h = normalize_f32(h) * scale + bias
        h = h @ w.t() + b
        if j != n_layers - 1:
            h = act(h)
    return h[:, 0]


def fused_mlp_score_reference(layers, features: torch.Tensor,
                              activation: str = "elu",
                              use_norm: bool = True) -> torch.Tensor:
    """Plain PyTorch version of K1: the JAX ``_layer_chain``."""
    h = features.reshape(-1, features.shape[-1])
    return _chain(h, _flat_params(layers), activation,
                  use_norm).reshape(features.shape[:-1])


def mlp_backward_reference(layers, x: torch.Tensor, g: torch.Tensor,
                           activation: str = "elu", use_norm: bool = True
                           ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Plain PyTorch version of K2: autograd through the plain forward.
    Returns ``dx [N, F]`` and one gradient per parameter, in
    ``_flat_params`` order (zeros for the LayerNorm affine without
    ``use_norm``, as JAX's kernel returns)."""
    with torch.enable_grad():
        xr = x.detach().requires_grad_(True)
        ps = [p.detach().requires_grad_(True) for p in _flat_params(layers)]
        out = _chain(xr, ps, activation, use_norm)
        grads = torch.autograd.grad(out, [xr] + ps, g, allow_unused=True)
    grads = [torch.zeros_like(t) if d is None else d
             for t, d in zip([xr] + ps, grads)]
    return grads[0], grads[1:]


def _load(name: str, source):
    built = build.build_library(name, [source])
    lib = ctypes.CDLL(str(built.path))
    lib.ultra_cuda_error_string.argtypes = [ctypes.c_int]
    lib.ultra_cuda_error_string.restype = ctypes.c_char_p
    return lib, built


@functools.lru_cache(maxsize=None)
def _library():
    lib, built = _load("mlp_fwd", SOURCE)
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
    return lib, built


@functools.lru_cache(maxsize=None)
def _bwd_library():
    lib, built = _load("mlp_bwd", BWD_SOURCE)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.ultra_mlp_bwd.argtypes = [ptr] * 8 + [
        i32, ctypes.POINTER(i32), i32, i32, i32, ptr]
    lib.ultra_mlp_bwd.restype = i32
    lib.ultra_mlp_bwd_workspace.argtypes = [
        ctypes.POINTER(i32), i32, i32] + [ctypes.POINTER(ctypes.c_longlong)] * 3
    lib.ultra_mlp_bwd_workspace.restype = i32
    lib.ultra_mlp_bwd_max_layers.argtypes = []
    lib.ultra_mlp_bwd_max_layers.restype = i32
    return lib, built


def build_kernel() -> build.BuiltLibrary:
    """Build (once per process) and load K1; returns the build record."""
    return _library()[1]


def build_backward_kernel() -> build.BuiltLibrary:
    """Build (once per process) and load K2; returns the build record."""
    return _bwd_library()[1]


def _cached(layers: nn.ModuleList, attr: str, make) -> torch.Tensor:
    """`make()` cached on `layers` under `attr` until a parameter changes
    (another tensor or an in-place update). Inference tensors keep no
    version counter, so parameters created under ``inference_mode`` are
    packed anew on every call."""
    params = _flat_params(layers)
    cacheable = not any(p.is_inference() for p in params)
    key = cacheable and tuple((p.data_ptr(), p._version) for p in params)
    cached = getattr(layers, attr, None)
    if cacheable and cached is not None and cached[0] == key:
        return cached[1]
    with torch.no_grad():
        buf = make().contiguous()
    if cacheable:
        setattr(layers, attr, (key, buf))
    return buf


def _packed(layers: nn.ModuleList) -> torch.Tensor:
    """The parameters as one contiguous buffer, per layer ``[scale, bias,
    W as [in, out], b]``, the layout K1 and K2 read and K2's gradients
    are written in."""
    return _cached(layers, "_k1_packed", lambda: torch.cat([
        t.detach().float().reshape(-1)
        for scale, bias, w, b in _layer_params(layers)
        for t in (scale, bias, w.t(), b)]))


def _packed_wt(layers: nn.ModuleList) -> torch.Tensor:
    """Each layer's W as ``[out, in]`` (``nn.Linear``'s own layout), one
    after the other: K2 reads it for ``dz @ W^T``."""
    return _cached(layers, "_k2_wt", lambda: torch.cat([
        layer.linear.weight.detach().float().reshape(-1)
        for layer in layers]))


def _check_launch(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: "
                           f"{lib.ultra_cuda_error_string(err)} "
                           f"(CUDA error {err})")


def mlp_forward(layers, x: torch.Tensor, activation: str,
                use_norm: bool) -> torch.Tensor:
    """K1's wrapper: ``[N, F]`` float32 rows -> ``[N]`` scores. A CPU tensor
    runs the plain version; a CUDA tensor launches K1."""
    if x.device.type == "cpu":
        return _chain(x, _flat_params(layers), activation, use_norm)
    if x.device.type != "cuda":
        raise ValueError(f"no K1 kernel for device {x.device}")
    if not x.is_contiguous():
        raise ValueError("features must be contiguous")
    lib, _ = _library()
    widths = _widths(layers)
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
        _check_launch(lib, err, "K1")
        fused_mlp_score.launches += 1
    return out


def mlp_backward(layers, x: torch.Tensor, g: torch.Tensor, activation: str,
                 use_norm: bool) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """K2's wrapper: ``dx [N, F]`` and the parameter gradients (in
    ``_flat_params`` order, ``nn.Linear`` layouts) for the scores'
    cotangent ``g [N]``. A CPU tensor runs the plain version; a CUDA
    tensor launches K2."""
    if x.device.type == "cpu":
        return mlp_backward_reference(layers, x, g, activation, use_norm)
    if x.device.type != "cuda":
        raise ValueError(f"no K2 kernel for device {x.device}")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("features must be contiguous float32")
    lib, _ = _bwd_library()
    widths = _widths(layers)
    n_layers, n = len(layers), x.shape[0]
    if n_layers > lib.ultra_mlp_bwd_max_layers():
        raise ValueError(f"{n_layers} layers exceed the kernel's "
                         f"{lib.ultra_mlp_bwd_max_layers()}")
    c_widths = (ctypes.c_int * len(widths))(*widths)
    sizes = [ctypes.c_longlong() for _ in range(3)]
    if lib.ultra_mlp_bwd_workspace(c_widths, n_layers, n,
                                   *map(ctypes.byref, sizes)) != 0:
        raise ValueError(f"K2 does not take the widths {list(widths)}")
    scratch_floats, partial_floats, smem = (s.value for s in sizes)
    if smem > SMEM_LIMIT:
        raise ValueError(f"widths {list(widths)} need {smem} B of shared "
                         f"memory, more than the {SMEM_LIMIT} B a block has")
    params, wt = _packed(layers), _packed_wt(layers)
    g = g.reshape(-1).float().contiguous()
    if params.device != x.device or g.device != x.device:
        raise ValueError(f"parameters on {params.device}, features on "
                         f"{x.device}, cotangent on {g.device}")
    dparams = torch.empty_like(params)
    dx = torch.empty_like(x)
    if n:
        scratch = torch.empty(scratch_floats, dtype=torch.float32,
                              device=x.device)
        partials = torch.empty(partial_floats, dtype=torch.float32,
                               device=x.device)
        with torch.cuda.device(x.device):
            err = lib.ultra_mlp_bwd(
                x.data_ptr(), g.data_ptr(), params.data_ptr(), wt.data_ptr(),
                dx.data_ptr(), dparams.data_ptr(), scratch.data_ptr(),
                partials.data_ptr(), n, c_widths, n_layers,
                ACTIVATION_CODES[activation], int(use_norm),
                torch.cuda.current_stream().cuda_stream)
        _check_launch(lib, err, "K2")
        mlp_backward.launches += 1
    else:
        dparams.zero_()
    grads, off = [], 0
    for d_in, d_out in zip(widths[:-1], widths[1:]):
        sizes = (d_in, d_in, d_in * d_out, d_out)
        dscale, dbias, dw, db = torch.split(dparams[off: off + sum(sizes)],
                                            sizes)
        grads += [dscale, dbias, dw.view(d_in, d_out).t(), db]
        off += sum(sizes)
    return dx, grads


mlp_backward.launches = 0  # kernel launches, for run-time evidence


class FusedMLP(torch.autograd.Function):
    """K1 forward, K2 backward. Inputs: ``x [N, F]``, the DNN's ``layers``
    (for the packed-parameter cache), the activation, ``use_norm``, then
    the flat parameter tensors that autograd differentiates."""

    @staticmethod
    def forward(ctx, x, layers, activation, use_norm, *params):
        ctx.layers, ctx.activation, ctx.use_norm = layers, activation, use_norm
        ctx.save_for_backward(x)
        return mlp_forward(layers, x, activation, use_norm)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        dx, grads = mlp_backward(ctx.layers, x, g, ctx.activation,
                                 ctx.use_norm)
        return (dx, None, None, None, *grads)


def fused_mlp_score(layers, features: torch.Tensor, activation: str = "elu",
                    use_norm: bool = True) -> torch.Tensor:
    """Score ``[B, L, F]`` (or ``[N, F]``) float32 features with K1;
    differentiable through K2.

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
    if features.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no K1 kernel for device {features.device}")
    x = features.reshape(-1, widths[0])
    out = FusedMLP.apply(x, layers, activation, use_norm,
                         *_flat_params(layers))
    return out.reshape(features.shape[:-1])


fused_mlp_score.launches = 0  # K1 launches, for run-time evidence
