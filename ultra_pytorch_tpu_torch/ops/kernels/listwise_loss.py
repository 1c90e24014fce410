"""K3 and K4: the fused propensity-weighted listwise softmax loss and its
gradient, CUDA kernels for Hopper.

Port of the TPU kernels ``_fwd_kernel`` (K3) and ``_bwd_kernel`` (K4) of
``ultra_pytorch_tpu/ops/pallas/listwise_loss.py`` (entry
``fused_softmax_loss``, a ``jax.custom_vjp``). The kernels live in
``csrc/listwise_loss.cu``. :func:`fused_softmax_loss` applies
:class:`FusedSoftmaxLoss`, whose forward is :func:`listwise_loss_forward`
(K3) and whose backward is :func:`listwise_loss_backward` (K4):

    d loss / d s = g * (denom_b / total) * (softmax(s~) - label_dis) * mask

Labels, weights and mask take no gradient, as in JAX. Each wrapper runs
its plain version (``ops.losses.softmax_loss`` and autograd through it)
on a CPU tensor, and on a CUDA tensor launches its kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ultra_pytorch_tpu_torch.ops import losses
from ultra_pytorch_tpu_torch.ops.kernels import build

SOURCE = build.CSRC_DIR / "listwise_loss.cu"


@functools.lru_cache(maxsize=None)
def _library():
    built = build.build_library("listwise_loss", [SOURCE])
    lib = ctypes.CDLL(str(built.path))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.ultra_listwise_loss_fwd.argtypes = [ptr] * 5 + [i32, i32, ptr]
    lib.ultra_listwise_loss_fwd.restype = i32
    lib.ultra_listwise_loss_bwd.argtypes = [ptr] * 6 + [i32, i32, ptr]
    lib.ultra_listwise_loss_bwd.restype = i32
    lib.ultra_cuda_error_string.argtypes = [i32]
    lib.ultra_cuda_error_string.restype = ctypes.c_char_p
    return lib, built


def build_kernel() -> build.BuiltLibrary:
    """Build (once per process) and load K3/K4; returns the build record."""
    return _library()[1]


def _checked(s, y, w, m):
    """The four [B, L] inputs as contiguous float32 on one CUDA device."""
    if s.dim() != 2:
        raise ValueError(f"scores must be [B, L], got {tuple(s.shape)}")
    out = []
    for name, t in (("scores", s), ("labels", y), ("weights", w),
                    ("mask", m)):
        if t.shape != s.shape:
            raise ValueError(f"{name} {tuple(t.shape)} != scores "
                             f"{tuple(s.shape)}")
        if t.device != s.device:
            raise ValueError(f"{name} on {t.device}, scores on {s.device}")
        out.append(t.detach().float().contiguous())
    return out


def _launch(fn, what, *args):
    lib, _ = _library()
    with torch.cuda.device(args[0].device):
        err = getattr(lib, fn)(
            *[a.data_ptr() for a in args], args[0].shape[0],
            args[0].shape[1], torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{what} launch failed: "
                           f"{lib.ultra_cuda_error_string(err)} "
                           f"(CUDA error {err})")


def listwise_loss_forward(s, y, w, m) -> torch.Tensor:
    """K3's wrapper: the scalar loss (a 0-dim float32 tensor)."""
    if s.device.type == "cpu":
        with torch.no_grad():
            return losses.softmax_loss(s, y, w, m)
    if s.device.type != "cuda":
        raise ValueError(f"no K3 kernel for device {s.device}")
    s, y, w, m = _checked(s, y, w, m)
    out = torch.empty((), dtype=torch.float32, device=s.device)
    if s.numel() == 0:
        return out.zero_()
    _launch("ultra_listwise_loss_fwd", "K3", s, y, w, m, out)
    listwise_loss_forward.launches += 1
    return out


listwise_loss_forward.launches = 0  # kernel launches, for run-time evidence


def listwise_loss_backward(s, y, w, m, g) -> torch.Tensor:
    """K4's wrapper: ``ds [B, L]`` for the scalar cotangent `g`."""
    if s.device.type == "cpu":
        with torch.enable_grad():
            sr = s.detach().requires_grad_(True)
            loss = losses.softmax_loss(sr, y, w, m)
            (ds,) = torch.autograd.grad(loss, sr, g)
        return ds
    if s.device.type != "cuda":
        raise ValueError(f"no K4 kernel for device {s.device}")
    s, y, w, m = _checked(s, y, w, m)
    g = g.detach().float().reshape(1).contiguous()
    ds = torch.empty_like(s)
    if s.numel() == 0:
        return ds
    _launch("ultra_listwise_loss_bwd", "K4", s, y, w, m, g, ds)
    listwise_loss_backward.launches += 1
    return ds


listwise_loss_backward.launches = 0  # kernel launches, for run-time evidence


class FusedSoftmaxLoss(torch.autograd.Function):
    """K3 forward, K4 backward; only the scores take a gradient."""

    @staticmethod
    def forward(ctx, s, y, w, m):
        ctx.save_for_backward(s, y, w, m)
        return listwise_loss_forward(s, y, w, m)

    @staticmethod
    def backward(ctx, g):
        s, y, w, m = ctx.saved_tensors
        return listwise_loss_backward(s, y, w, m, g), None, None, None


def fused_softmax_loss(output: torch.Tensor, labels: torch.Tensor,
                       propensity_weights: torch.Tensor = None,
                       mask: torch.Tensor = None) -> torch.Tensor:
    """Drop-in fused equivalent of ``ops.losses.softmax_loss`` (labels,
    weights and mask take no gradient)."""
    if propensity_weights is None:
        propensity_weights = torch.ones_like(labels)
    if mask is None:
        mask = torch.ones_like(labels)
    return FusedSoftmaxLoss.apply(
        output.float(), labels.detach().float(),
        propensity_weights.detach().float(), mask.detach().float())
