"""K3 and K4: the fused propensity-weighted listwise softmax loss and its
gradient, CUDA kernels for Hopper.

Port of the TPU kernels ``_fwd_kernel`` (K3) and ``_bwd_kernel`` (K4) of
``ultra_pytorch_tpu/ops/pallas/listwise_loss.py`` (entry
``fused_softmax_loss``, a ``jax.custom_vjp``). The kernels live in
``csrc/listwise_loss.cu``. :func:`fused_softmax_loss` applies
:class:`FusedSoftmaxLoss`, whose forward is :func:`listwise_loss_forward`
(K3) and whose backward is :func:`listwise_loss_backward` (K4):

    d loss / d s = g * (denom_b / total) * (softmax(s~) - label_dis) * mask

K3 also returns the residual K4 reads (:class:`LossStats`: per list
``log_z = max + lse`` of the masked scores and ``denom``, then ``total``,
in one buffer), so K4 reads each list once and reduces nothing. Labels, weights and mask take no
gradient, as in JAX. Each wrapper runs its plain version
(``ops.losses.softmax_loss``, :func:`listwise_loss_stats_reference`,
:func:`listwise_loss_backward_reference`) on a CPU tensor, and on a CUDA
tensor launches its kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ultra_pytorch_tpu_torch.ops import losses
from ultra_pytorch_tpu_torch.ops.kernels import build
from ultra_pytorch_tpu_torch.utils import spans

SOURCE = build.CSRC_DIR / "listwise_loss.cu"
PER_LANE = 8        # elements a lane holds per chunk (``kPer`` in the source)
MAX_THREADS = 512   # most threads a block (``kMaxThreads``)
# Block sizes by ``torch_loss_probe.py`` on an H100: K3 sums its blocks'
# partials after a ticket, so fewer, larger blocks win at [16384, 10] and
# [1024, 200]; K4 has no reduction and is fastest with 128-thread blocks at
# every shape probed (PERF.md, section 6).
K3_THREADS = 512
K4_THREADS = 128


class LossStats:
    """K3's residual for K4: one float32 tensor ``buffer`` of 2B + 1
    values, per list ``log_z`` (the logsumexp of the masked scores) and
    ``denom`` interleaved, then ``total``, laid out as K3 writes it; the
    three are views of it."""

    __slots__ = ("buffer",)

    def __init__(self, buffer: torch.Tensor):
        self.buffer = buffer

    @classmethod
    def of(cls, total, log_z, denom) -> "LossStats":
        return cls(torch.cat([torch.stack([log_z, denom], 1).reshape(-1),
                              total.reshape(1)]))

    @property
    def total(self) -> torch.Tensor:
        return self.buffer[-1]

    @property
    def log_z(self) -> torch.Tensor:
        return self.buffer[0:-1:2]

    @property
    def denom(self) -> torch.Tensor:
        return self.buffer[1:-1:2]


class Geometry(NamedTuple):
    lanes: int    # lanes a list (G), a power of two from 1 to 32
    chunks: int   # chunks of lanes * PER_LANE elements a list
    threads: int  # threads a block, a multiple of 32
    blocks: int


def lanes_per_list(length: int) -> int:
    """The fewest lanes, a power of two up to 32, that hold a list of
    `length` in at most PER_LANE elements a lane (32 for longer lists,
    which are read in chunks)."""
    lanes = 1
    while lanes < 32 and -(-length // lanes) > PER_LANE:
        lanes *= 2
    return lanes


@functools.lru_cache(maxsize=256)
def launch_geometry(batch: int, length: int,
                    max_threads: int = MAX_THREADS) -> Geometry:
    """K3/K4's launch for a [batch, length] input: one group of lanes a
    list, one block when the batch fits in `max_threads` lanes, else as
    many blocks of `max_threads` as it needs."""
    lanes = lanes_per_list(length)
    total_lanes = batch * lanes
    threads = min(max_threads, -(-total_lanes // 32) * 32)
    return Geometry(lanes, -(-length // (lanes * PER_LANE)), threads,
                    -(-total_lanes // threads))


@functools.lru_cache(maxsize=None)
def _library():
    built = build.build_library("listwise_loss", [SOURCE])
    lib = ctypes.CDLL(str(built.path))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    # s y w m, their row strides, B L G, threads, blocks
    inputs = [ptr] * 4 + [i64] * 4 + [i32] * 5
    # out, stats, partials, ticket / stats, g, ds; then the stream
    lib.ultra_listwise_loss_fwd.argtypes = inputs + [ptr] * 5
    lib.ultra_listwise_loss_fwd.restype = i32
    lib.ultra_listwise_loss_bwd.argtypes = inputs + [ptr] * 4
    lib.ultra_listwise_loss_bwd.restype = i32
    lib.ultra_cuda_error_string.argtypes = [i32]
    lib.ultra_cuda_error_string.restype = ctypes.c_char_p
    return lib, built


def build_kernel() -> build.BuiltLibrary:
    """Build (once per process) and load K3/K4; returns the build record."""
    return _library()[1]


@functools.lru_cache(maxsize=None)
def _ticket(device: torch.device) -> torch.Tensor:
    """K3's block counter on `device`, zeroed once; the kernel's last block
    puts it back to 0. K3 launches on one device must therefore not run
    concurrently on two streams."""
    return torch.zeros(1, dtype=torch.int32, device=device)


def _checked(s, y, w, m):
    """Data pointers and row strides of the four [B, L] float32 inputs on
    s's device. A tensor goes in as it lies when its elements are adjacent
    within a row (any row stride, 0 included), else as a contiguous copy
    (returned with them: the caller holds it until the launch is
    enqueued, so its memory is not handed out before the kernel reads
    it)."""
    if s.dim() != 2:
        raise ValueError(f"scores must be [B, L], got {tuple(s.shape)}")
    shape, device = s.shape, s.get_device()
    alive, ptrs, strides = [], [], []
    for name, t in (("scores", s), ("labels", y), ("weights", w),
                    ("mask", m)):
        if t.shape != shape or t.get_device() != device or \
                t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 {tuple(shape)} on "
                             f"{s.device}, got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")
        row, col = t.stride()
        if col != 1 and shape[1] != 1:
            t = t.contiguous()
            row = t.stride(0)
        alive.append(t)
        ptrs.append(t.data_ptr())
        strides.append(row)
    return alive, ptrs + strides


def _launch(device, fn, what, *args):
    lib, _ = _library()
    with torch.cuda.device(device):
        err = getattr(lib, fn)(*args,
                               torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{what} launch failed: "
                           f"{lib.ultra_cuda_error_string(err)} "
                           f"(CUDA error {err})")


def listwise_loss_stats_reference(s, y, w, m) -> LossStats:
    """K3's residual as plain tensor ops: ``total = sum(wl)``, and per list
    ``log_z = max + log(sum(exp(s~ - max)))`` and ``denom = sum(wl)``."""
    wl = (y + 1e-7) * w * m
    s_masked = torch.where(m > 0, s, torch.full_like(s, losses.NEG_INF))
    mx = s_masked.max(dim=1).values
    lse = torch.log(torch.exp(s_masked - mx[:, None]).sum(dim=1))
    return LossStats.of(wl.sum(), mx + lse, wl.sum(dim=1))


def listwise_loss_backward_reference(s, y, w, m, g, stats: LossStats):
    """K4 as plain tensor ops: ``ds`` from the inputs and K3's residual."""
    wl = (y + 1e-7) * w * m
    d = stats.denom[:, None]
    label_dis = torch.where(d > 0, wl / torch.where(d > 0, d, 1.0), 0.0)
    s_masked = torch.where(m > 0, s, torch.full_like(s, losses.NEG_INF))
    p = torch.exp(s_masked - stats.log_z[:, None])
    total = stats.total
    scale = d / torch.where(total > 0, total, 1.0)
    return g * scale * (p - label_dis) * m


def listwise_loss_forward(s, y, w, m, return_stats: bool = False,
                          _threads: int = K3_THREADS):
    """K3's wrapper: the scalar loss (a 0-dim float32 tensor), and with
    `return_stats` also the :class:`LossStats` residual for K4.
    `_threads` (a multiple of 32 up to MAX_THREADS) caps the block size,
    for ``torch_loss_probe.py``."""
    if s.device.type == "cpu":
        with torch.no_grad():
            loss = losses.softmax_loss(s, y, w, m)
            return (loss, listwise_loss_stats_reference(s, y, w, m)) \
                if return_stats else loss
    if s.device.type != "cuda":
        raise ValueError(f"no K3 kernel for device {s.device}")
    alive, args = _checked(s, y, w, m)
    batch, length = s.shape
    device = s.device
    out = torch.empty((), dtype=torch.float32, device=device)
    stats = torch.empty(2 * batch + 1, dtype=torch.float32, device=device)
    if s.numel() == 0:
        out.zero_()
        stats.zero_()
    else:
        geo = launch_geometry(batch, length, _threads)
        # Two partial sums a block, read only when there are several.
        partials = stats if geo.blocks == 1 else torch.empty(
            2 * geo.blocks, dtype=torch.float32, device=device)
        _launch(device, "ultra_listwise_loss_fwd", "K3", *args, batch,
                length, geo.lanes, geo.threads, geo.blocks, out.data_ptr(),
                stats.data_ptr(), partials.data_ptr(),
                _ticket(device).data_ptr())
        spans.count("launches.K3")
    return (out, LossStats(stats)) if return_stats else out


def listwise_loss_backward(s, y, w, m, g, stats: LossStats,
                           _threads: int = K4_THREADS) -> torch.Tensor:
    """K4's wrapper: ``ds [B, L]`` for the scalar cotangent `g`, from K3's
    residual `stats` (`_threads` as in :func:`listwise_loss_forward`)."""
    if s.device.type == "cpu":
        return listwise_loss_backward_reference(s, y, w, m, g, stats)
    if s.device.type != "cuda":
        raise ValueError(f"no K4 kernel for device {s.device}")
    alive, args = _checked(s, y, w, m)
    batch, length = s.shape
    device = s.get_device()
    buffer = stats.buffer
    if buffer.shape != (2 * batch + 1,) or buffer.get_device() != device \
            or buffer.dtype != torch.float32 or buffer.stride(0) != 1:
        raise ValueError(f"the residual must be contiguous float32 "
                         f"({2 * batch + 1},) on {s.device}, got "
                         f"{buffer.dtype} {tuple(buffer.shape)} on "
                         f"{buffer.device}")
    if g.shape != () or g.get_device() != device or g.dtype != torch.float32:
        raise ValueError(f"the cotangent must be a float32 scalar on "
                         f"{s.device}, got {g.dtype} {tuple(g.shape)} on "
                         f"{g.device}")
    ds = torch.empty(s.shape, dtype=torch.float32, device=s.device)
    if s.numel() == 0:
        return ds
    geo = launch_geometry(batch, length, _threads)
    _launch(s.device, "ultra_listwise_loss_bwd", "K4", *args, batch, length,
            geo.lanes, geo.threads, geo.blocks, buffer.data_ptr(),
            g.data_ptr(), ds.data_ptr())
    spans.count("launches.K4")
    return ds


class FusedSoftmaxLoss(torch.autograd.Function):
    """K3 forward, K4 backward from K3's residual; only the scores take a
    gradient."""

    @staticmethod
    def forward(ctx, s, y, w, m):
        loss, stats = listwise_loss_forward(s, y, w, m, return_stats=True)
        ctx.save_for_backward(s, y, w, m, stats.buffer)
        return loss

    @staticmethod
    def backward(ctx, g):
        s, y, w, m, buffer = ctx.saved_tensors
        return (listwise_loss_backward(s, y, w, m, g, LossStats(buffer)),
                None, None, None)


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
