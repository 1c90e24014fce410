"""K1 and K2: the DNN ranker's fused MLP forward and backward, CUDA
kernels for Hopper. K1 has two designs: ``mma.sync`` on 16-, 32- or
64-row tiles (``csrc/mlp_fwd.cu``), which also saves K2's residuals, and
warpgroup MMAs (``wgmma``) on 64-row tiles fed by bulk copies of the
weights split once a call (``csrc/mlp_fwd_wg.cu``). :func:`takes_wgmma`
chooses the second where no residual is saved, ``rows_per_block`` picks
64-row tiles and its shared memory fits the widths (the online learners'
whole lists, the 256x128 serving bucket); the first everywhere else.

Port of the TPU kernels ``_kernel`` (K1) and ``_bwd_kernel`` (K2) of
``ultra_pytorch_tpu/ops/pallas/mlp.py`` (entry ``fused_mlp_score``, a
``jax.custom_vjp``). K1 (``csrc/mlp_fwd.cu``) scores every row of ``[N, F]``
features through the whole layer chain, LayerNorm -> Linear -> activation
per layer, keeping each row tile's activations in shared memory. K2
(``csrc/mlp_bwd.cu``) backpropagates through that chain, in deterministic
phases, from the forward's residuals that K1 saved: where the TPU kernel
recomputes the forward per row tile, K1 in its saving mode writes each
layer's LayerNorm output, its input and each row's mean and rstd as it
scores (:func:`residual_layout`; 19.8 MB at a training step's 2,560 rows
at the widths 136, 512, 256, 128, 1), and K2 runs only the backward:
2.43 GFLOP there, with 9.2 MB of scratch. Both run their products on the
tensor cores at float32 accuracy (3xTF32, ``csrc/mlp_common.cuh``) and
read the parameters where PyTorch keeps them (``nn.Linear``'s ``[out,
in]`` weight included), so nothing is repacked after an optimizer step
(the wgmma instance splits them into a scratch at every call).

:func:`fused_mlp_score` keeps the JAX signature and is differentiable: it
applies :class:`FusedMLP`, a ``torch.autograd.Function`` whose forward is
:func:`mlp_forward` (K1) and whose backward is :func:`mlp_backward` (K2).
On the card K1 saves the residuals only where autograd records the call
(:func:`autograd_records`: grad mode on and some input needing a
gradient), so only where a backward can follow: under ``torch.no_grad``
or ``torch.inference_mode`` (serving, validation) it writes nothing but
the scores. Each of the two wrappers

* on a CPU tensor runs its plain PyTorch version
  (:func:`fused_mlp_score_reference`, and autograd through it; the CPU
  path keeps no residual);
* on a CUDA tensor launches its kernel or raises. Nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import (Callable, Dict, List, NamedTuple, Optional,
                    Sequence, Tuple, Union)

import torch

from ultra_pytorch_tpu_torch.models.base import ACTIVATIONS, normalize_f32
from ultra_pytorch_tpu_torch.ops.kernels import build
from ultra_pytorch_tpu_torch.utils import spans

# The kernels' activation codes (``activate`` in csrc/mlp_common.cuh).
ACTIVATION_CODES = {"elu": 0, "relu": 1, "selu": 2, "tanh": 3, "sigmoid": 4}
SMEM_LIMIT = 232_448  # dynamic shared memory one Hopper block can have
ROWS_PER_BLOCK = (64, 32, 16)  # K1/K2 row-tile instances, largest first
# The tiles K2 chooses from. On its residual K2's phase 1 runs one product
# a layer, and there a 64-row tile's shallower weight stages cost more than
# sharing each staged weight among twice the rows saves: at 12,800, 30,720
# and 32,768 rows 32-row tiles ran K2 2.7-3.3% faster than the 64-row ones
# (torch_mlp_probe.py on an H100 at 700 W), where K1 keeps 64-row tiles.
K2_ROWS_PER_BLOCK = (32, 16)
# A tile's fixed cost in rows' worth of work: one wave of 64-row tiles took
# K1 0.155 ms and of 32-row tiles 0.085 ms on an H100 (torch_mlp_probe.py),
# which a fixed cost of about 7 rows fits.
TILE_COST_ROWS = 8
DW_TILE = 64  # K2's dW tile (csrc/mlp_bwd.cu kTo, kTi)
DW_ROWS = 32  # K2's rows of N a dW stage (csrc/mlp_bwd.cu kKr)
# dW blocks per SM (four 128-thread blocks of 55 KB fit one): at 2,560
# rows K2's dW kernel took 0.0382 ms with four, 0.0444 with two and 0.0372
# with eight (torch_mlp_probe.py on an H100 at 700 W); four keeps
# the partials that its last kernel sums fewer.
DW_BLOCKS_PER_SM = 4
# K1's wgmma instance (csrc/mlp_fwd_wg.cu), built into K1's library:
# 64-row tiles, two consumer warpgroups of at most 256 columns each, a ring
# of three 32 KB weight stages. `_rows=WGMMA` forces it.
WG_ROWS, WG_MAX_WIDTH, WG_RING_BYTES = 64, 512, 3 * 32768
WGMMA = "wgmma"
SOURCE = build.CSRC_DIR / "mlp_fwd.cu"
WG_SOURCE = build.CSRC_DIR / "mlp_fwd_wg.cu"
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


def residual_layout(widths: Sequence[int], n_rows: int, use_norm: bool
                    ) -> Tuple[List[Dict[str, Tuple[int, Tuple[int, ...]]]],
                               int]:
    """Where K1's saving mode puts the forward's residuals for K2 in one
    float32 buffer (csrc/mlp_common.cuh ``residual_plan``): per layer
    ``{name: (offset, shape)}`` with ``post`` ``[N, in]`` (the LayerNorm
    output, or the layer's input without LayerNorm) and, with LayerNorm,
    ``h`` ``[N, in]`` (its input; not for the first layer, whose input is
    x), ``mean`` and ``rstd`` ``[N]``; then the buffer's floats. Every
    part starts on 16 bytes."""
    layout, off = [], 0
    for j, d_in in enumerate(widths[:-1]):
        parts = {"post": (n_rows, d_in)}
        if use_norm:
            if j:
                parts["h"] = (n_rows, d_in)
            parts.update(mean=(n_rows,), rstd=(n_rows,))
        layer = {}
        for name, shape in parts.items():
            layer[name] = (off, shape)
            off += -(-math.prod(shape) // 4) * 4
        layout.append(layer)
    return layout, off


def residual_views(residual: torch.Tensor, widths: Sequence[int],
                   n_rows: int, use_norm: bool
                   ) -> List[Dict[str, torch.Tensor]]:
    """The residual buffer as one view per part of :func:`residual_layout`,
    per layer."""
    layout, _ = residual_layout(widths, n_rows, use_norm)
    return [{name: residual[off: off + math.prod(shape)].view(shape)
             for name, (off, shape) in layer.items()} for layer in layout]


def mlp_residual_reference(layers, x: torch.Tensor, activation: str,
                           use_norm: bool) -> torch.Tensor:
    """Plain PyTorch version of K1's saving mode: the plain chain's
    intermediates of ``[N, F]`` rows in the layout of
    :func:`residual_layout` (padding zero)."""
    widths, n = _widths(layers), x.shape[0]
    act = ACTIVATIONS[activation]
    residual = x.new_zeros(residual_layout(widths, n, use_norm)[1])
    h = x.detach()
    views_of = residual_views(residual, widths, n, use_norm)
    for j, (views, layer) in enumerate(zip(views_of, layers)):
        if use_norm:
            if j:
                views["h"].copy_(h)
            mean = h.mean(-1)
            var = (h * h).mean(-1) - mean * mean
            views["mean"].copy_(mean)
            views["rstd"].copy_(torch.rsqrt(var.clamp_min(0.0) + 1e-5))
            h = normalize_f32(h) * layer.norm.weight.detach() \
                + layer.norm.bias.detach()
        views["post"].copy_(h)
        h = h @ layer.linear.weight.detach().t() + layer.linear.bias.detach()
        if j != len(layers) - 1:
            h = act(h)
    return residual


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


def _load(name: str, *sources):
    built = build.build_library(name, sources)
    lib = ctypes.CDLL(str(built.path))
    lib.ultra_cuda_error_string.argtypes = [ctypes.c_int]
    lib.ultra_cuda_error_string.restype = ctypes.c_char_p
    return lib, built


_PTR, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@functools.lru_cache(maxsize=None)
def _library():
    lib, built = _load("mlp_fwd", SOURCE, WG_SOURCE)
    lib.ultra_mlp_fwd.argtypes = [
        _PTR, ctypes.POINTER(_PTR), _PTR, _PTR, _I64, _I32,
        ctypes.POINTER(_I32), _I32, _I32, _I32, _I32, _PTR]
    lib.ultra_mlp_fwd.restype = _I32
    lib.ultra_mlp_fwd_smem_bytes.argtypes = [ctypes.POINTER(_I32), _I32,
                                             _I32]
    lib.ultra_mlp_fwd_smem_bytes.restype = _I64
    lib.ultra_mlp_fwd_max_layers.argtypes = []
    lib.ultra_mlp_fwd_max_layers.restype = _I32
    lib.ultra_mlp_fwd_wg.argtypes = [
        _PTR, ctypes.POINTER(_PTR), _PTR, _PTR, _I64, _I32,
        ctypes.POINTER(_I32)] + [_I32] * 4 + [_PTR]
    lib.ultra_mlp_fwd_wg.restype = _I32
    for name in ("ultra_mlp_fwd_wg_smem_bytes",
                 "ultra_mlp_fwd_wg_scratch_floats"):
        getattr(lib, name).argtypes = [ctypes.POINTER(_I32), _I32]
        getattr(lib, name).restype = _I64
    return lib, built


@functools.lru_cache(maxsize=None)
def _bwd_library():
    lib, built = _load("mlp_bwd", BWD_SOURCE)
    lib.ultra_mlp_bwd.argtypes = [
        _PTR, _PTR, _PTR, _I64, ctypes.POINTER(_PTR)] + [_PTR] * 5 + [
        _I32, ctypes.POINTER(_I32)] + [_I32] * 5 + [_PTR]
    lib.ultra_mlp_bwd.restype = _I32
    lib.ultra_mlp_bwd_workspace.argtypes = [
        ctypes.POINTER(_I32)] + [_I32] * 4 + [ctypes.POINTER(_I64)] * 4
    lib.ultra_mlp_bwd_workspace.restype = _I32
    lib.ultra_mlp_bwd_max_layers.argtypes = []
    lib.ultra_mlp_bwd_max_layers.restype = _I32
    return lib, built


def build_kernel() -> build.BuiltLibrary:
    """Build (once per process) and load K1; returns the build record."""
    return _library()[1]


def build_backward_kernel() -> build.BuiltLibrary:
    """Build (once per process) and load K2; returns the build record."""
    return _bwd_library()[1]


def rows_per_block(n_rows: int, n_sms: int, smem_of: Callable[[int], int],
                   candidates: Sequence[int] = ROWS_PER_BLOCK) -> int:
    """Rows one K1/K2 block takes (a template instance of the kernels): of
    the `candidates` (K1: ``ROWS_PER_BLOCK``, K2: ``K2_ROWS_PER_BLOCK``)
    whose shared memory ``smem_of(rows)`` fits, the one that leaves the
    busiest SM the least work, the larger on a tie. An
    SM's work is its waves of blocks times each block's rows plus
    ``TILE_COST_ROWS``, a tile's fixed cost (staging every layer's weights
    whatever its rows): a larger tile shares each staged weight among more
    rows. On an H100 (torch_mlp_probe.py) it picks the fastest tile at
    128, 1,000, 2,560, 30,720 and 32,768 rows: at 128 and 1,000 rows
    16-row tiles ran K1 3-9% and K2 6-7% faster than 32-row ones; at 30,720
    rows (the online lists, 256 x 120) 64-row tiles ran K1 21% faster than
    16-row ones, which leave the busiest SM fewer rows, and 32-row tiles
    ran K2 10% faster than 16-row ones."""
    fitting = [r for r in candidates if 0 < smem_of(r) <= SMEM_LIMIT]
    if not fitting:
        least = candidates[-1]
        raise ValueError(f"{least} rows a block need {smem_of(least)} B of "
                         f"shared memory, more than the {SMEM_LIMIT} B a "
                         "block has")

    def busiest(rows):
        waves = -(-(-(-n_rows // rows)) // n_sms)
        return waves * (rows + TILE_COST_ROWS)

    return min(fitting, key=lambda rows: (busiest(rows), -rows))


def dw_tiles(widths: Sequence[int]) -> int:
    """K2's dW tiles: ``DW_TILE`` x ``DW_TILE`` blocks of every layer's
    ``[out, in]`` gradient."""
    return sum(-(-d_out // DW_TILE) * -(-d_in // DW_TILE)
               for d_in, d_out in zip(widths[:-1], widths[1:]))


def dw_chunks(n_rows: int, widths: Sequence[int], n_sms: int,
              per_sm: int = DW_BLOCKS_PER_SM) -> int:
    """Row chunks of K2's dW phase: enough that tiles x chunks make
    `per_sm` blocks per SM, and no chunk shorter than one ``DW_ROWS``
    stage."""
    want = -(-per_sm * n_sms // dw_tiles(widths))
    return max(1, min(want, -(-n_rows // DW_ROWS)))


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _param_pointers(layers, device: torch.device) -> List[int]:
    """The device addresses the kernels read, per layer ``[LayerNorm scale,
    LayerNorm bias, W [out, in], b]``: the parameters themselves, never a
    copy, so an optimizer step needs no repacking."""
    ptrs = []
    for p in _flat_params(layers):
        if (p.device != device or p.dtype != torch.float32
                or not p.is_contiguous()):
            raise ValueError(f"parameter {tuple(p.shape)} must be contiguous "
                             f"float32 on {device}, got {p.dtype} on "
                             f"{p.device}")
        ptrs.append(p.data_ptr())
    return ptrs


def grad_views(dparams: torch.Tensor, widths: Sequence[int]
               ) -> List[torch.Tensor]:
    """K2's gradient buffer, per layer ``[dscale (in), dbias (in), dW (out x
    in), db (out)]``, as one tensor per parameter in ``_flat_params`` order
    and ``nn.Linear``'s layouts."""
    grads, off = [], 0
    for d_in, d_out in zip(widths[:-1], widths[1:]):
        sizes = (d_in, d_in, d_in * d_out, d_out)
        dscale, dbias, dw, db = torch.split(dparams[off: off + sum(sizes)],
                                            sizes)
        grads += [dscale, dbias, dw.view(d_out, d_in), db]
        off += sum(sizes)
    return grads


def _c_ints(values):
    return (_I32 * len(values))(*values)


def _check_launch(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: "
                           f"{lib.ultra_cuda_error_string(err)} "
                           f"(CUDA error {err})")


def _check_layers(lib_max: int, n_layers: int) -> None:
    if n_layers > lib_max:
        raise ValueError(f"{n_layers} layers exceed the kernel's {lib_max}")


def wg_smem_bytes(widths: Sequence[int]) -> int:
    """Shared memory of K1's wgmma instance for these widths, as
    csrc/mlp_fwd_wg.cu ``wg_smem`` counts it: the weight ring, one
    activation buffer of the widest layer input (64 rows at mlp_common.cuh's
    ``act_stride``) and six barriers; 0 where a hidden layer is wider than
    its two warpgroups' 512 columns."""
    if any(w > WG_MAX_WIDTH for w in widths[1:-1]):
        return 0
    stride = -(-max(widths[:-1]) // 8) * 8 + 4
    return WG_RING_BYTES + 4 * WG_ROWS * stride + 48


def takes_wgmma(rows: int, saving: bool, widths: Sequence[int]) -> bool:
    """Whether K1 runs its wgmma instance (csrc/mlp_fwd_wg.cu) rather than
    a ``mma.sync`` one: no residual is saved, ``rows_per_block`` picked
    64-row tiles (so it is a function of the rows and SMs too) and its
    shared memory fits these widths. At F = 700, where 64-row tiles do
    not fit, the 16-row ``mma.sync`` instance stays."""
    return (not saving and rows == WG_ROWS
            and 0 < wg_smem_bytes(widths) <= SMEM_LIMIT)


class _FwdPlan(NamedTuple):
    """K1's instance for a shape (:func:`_fwd_plan`)."""

    rows: int            # rows a block
    wgmma: bool          # the wgmma instance, else mma.sync's of `rows`
    scratch_floats: int  # the wgmma instance's split weights
    c_widths: ctypes.Array


@functools.lru_cache(maxsize=256)
def _fwd_plan(widths: Tuple[int, ...], n: int, n_sms: int,
              saving: bool = False,
              rows: Optional[Union[int, str]] = None) -> _FwdPlan:
    """K1's instance for `n` rows, saving residuals or not: pure in its
    arguments, so chosen once per shape and not on every call. `rows`
    forces a ``mma.sync`` tile instance (16, 32 or 64) or, as ``WGMMA``,
    the wgmma instance, instead of ``rows_per_block`` and
    ``takes_wgmma``'s choice."""
    lib, _ = _library()
    n_layers = len(widths) - 1
    _check_layers(lib.ultra_mlp_fwd_max_layers(), n_layers)
    c_widths = _c_ints(widths)
    if rows is None:
        rows = rows_per_block(n, n_sms, lambda r: lib.ultra_mlp_fwd_smem_bytes(
            c_widths, n_layers, r))
        wgmma = takes_wgmma(rows, saving, widths)
    elif rows == WGMMA:
        if saving or not 0 < wg_smem_bytes(widths) <= SMEM_LIMIT:
            raise ValueError("the wgmma instance of K1 saves no residual and "
                             f"takes hidden widths up to {WG_MAX_WIDTH}")
        rows, wgmma = WG_ROWS, True
    elif rows in ROWS_PER_BLOCK:
        wgmma = False
    else:
        raise ValueError(f"no K1 instance of {rows} rows a block")
    floats = (lib.ultra_mlp_fwd_wg_scratch_floats(c_widths, n_layers)
              if wgmma else 0)
    return _FwdPlan(rows, wgmma, floats, c_widths)


def new_residual(layers, x: torch.Tensor, use_norm: bool) -> torch.Tensor:
    """An empty residual buffer for K1 to save `x`'s rows into."""
    return torch.empty(residual_layout(_widths(layers), x.shape[0],
                                       use_norm)[1],
                       dtype=torch.float32, device=x.device)


def mlp_forward(layers, x: torch.Tensor, activation: str, use_norm: bool,
                _rows: Optional[Union[int, str]] = None,
                residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K1's wrapper: ``[N, F]`` float32 rows -> ``[N]`` scores. A CPU tensor
    runs the plain version; a CUDA tensor launches K1, which with
    `residual` (from :func:`new_residual`) also saves the forward's
    residuals there for K2. `_rows` forces its instance (for
    measurements): 16, 32 or 64 rows a block of ``mma.sync``, or
    ``WGMMA``."""
    if x.device.type == "cpu":
        if residual is not None:
            raise ValueError("the plain version keeps no residual")
        return _chain(x, _flat_params(layers), activation, use_norm)
    if x.device.type != "cuda":
        raise ValueError(f"no K1 kernel for device {x.device}")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("features must be contiguous float32")
    lib, _ = _library()
    n = x.shape[0]
    ptrs = _param_pointers(layers, x.device)
    out = torch.empty(n, dtype=torch.float32, device=x.device)
    if n:
        plan = _fwd_plan(_widths(layers), n, _sm_count(x.device),
                         residual is not None, _rows)
        table = (_PTR * len(ptrs))(*ptrs)
        act = ACTIVATION_CODES[activation]
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream
            if plan.wgmma:
                scratch = torch.empty(plan.scratch_floats,
                                      dtype=torch.float32, device=x.device)
                err = lib.ultra_mlp_fwd_wg(
                    x.data_ptr(), table, out.data_ptr(), scratch.data_ptr(),
                    plan.scratch_floats, n, plan.c_widths, len(layers), act,
                    int(use_norm), _sm_count(x.device), stream)
            else:
                res_ptr, res_floats = (
                    (None, 0) if residual is None
                    else (residual.data_ptr(), residual.numel()))
                err = lib.ultra_mlp_fwd(
                    x.data_ptr(), table, out.data_ptr(), res_ptr, res_floats,
                    n, plan.c_widths, len(layers), plan.rows, act,
                    int(use_norm), stream)
        _check_launch(lib, err, "K1")
        spans.count("launches.K1")
        if plan.wgmma:
            spans.count("launches.K1_wgmma")
        if residual is not None:
            spans.count("launches.K1_saved")
    return out


def _bwd_workspace(lib, c_widths, n_layers: int, n: int, rows: int,
                   chunks: int):
    """(scratch, partial, dW-partial floats, shared-memory bytes) of K2, or
    None for rows it has no instance of."""
    sizes = [_I64() for _ in range(4)]
    if lib.ultra_mlp_bwd_workspace(c_widths, n_layers, n, rows, chunks,
                                   *map(ctypes.byref, sizes)) != 0:
        return None
    return tuple(s.value for s in sizes)


@functools.lru_cache(maxsize=256)
def _bwd_plan(widths: Tuple[int, ...], n: int, n_sms: int,
              rows: Optional[int] = None,
              dw_per_sm: int = DW_BLOCKS_PER_SM):
    """(rows a block, dW chunks, (scratch, partial, dW-partial floats),
    widths as C ints) of K2 for `n` rows, chosen once per shape. `rows`
    forces a tile instance (any of ``ROWS_PER_BLOCK``) instead of
    ``rows_per_block``'s choice."""
    lib, _ = _bwd_library()
    n_layers = len(widths) - 1
    _check_layers(lib.ultra_mlp_bwd_max_layers(), n_layers)
    c_widths = _c_ints(widths)
    chunks = dw_chunks(n, widths, n_sms, dw_per_sm)
    if rows is None:
        rows = rows_per_block(n, n_sms, lambda r: (_bwd_workspace(
            lib, c_widths, n_layers, n, r, chunks) or (0,) * 4)[3],
            K2_ROWS_PER_BLOCK)
    elif rows not in ROWS_PER_BLOCK:
        raise ValueError(f"no K2 instance of {rows} rows a block")
    sizes = _bwd_workspace(lib, c_widths, n_layers, n, rows, chunks)[:3]
    return rows, chunks, sizes, c_widths


def mlp_backward(layers, x: torch.Tensor, g: torch.Tensor, activation: str,
                 use_norm: bool, _rows: Optional[int] = None,
                 _dw_per_sm: int = DW_BLOCKS_PER_SM,
                 residual: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """K2's wrapper: ``dx [N, F]`` and the parameter gradients (in
    ``_flat_params`` order, ``nn.Linear`` layouts) for the scores'
    cotangent ``g [N]``. A CPU tensor runs the plain version; a CUDA
    tensor launches K2 on `residual`, what K1 saved of `x` under the same
    parameters, or, without one, first K1 in its saving mode. `_rows`
    forces K2's tile size and `_dw_per_sm` its dW blocks per SM (for
    measurements)."""
    if x.device.type == "cpu":
        return mlp_backward_reference(layers, x, g, activation, use_norm)
    if x.device.type != "cuda":
        raise ValueError(f"no K2 kernel for device {x.device}")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("features must be contiguous float32")
    lib, _ = _bwd_library()
    widths = _widths(layers)
    n = x.shape[0]
    ptrs = _param_pointers(layers, x.device)
    g = g.reshape(-1).float().contiguous()
    if g.device != x.device:
        raise ValueError(f"features on {x.device}, cotangent on {g.device}")
    dparams = torch.empty(sum(p.numel() for p in _flat_params(layers)),
                          dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    if n:
        if residual is None:
            residual = new_residual(layers, x, use_norm)
            mlp_forward(layers, x, activation, use_norm, residual=residual)
        rows, chunks, sizes, c_widths = _bwd_plan(
            widths, n, _sm_count(x.device), _rows, _dw_per_sm)
        scratch, partials, dw_part = (
            torch.empty(size, dtype=torch.float32, device=x.device)
            for size in sizes)
        with torch.cuda.device(x.device):
            err = lib.ultra_mlp_bwd(
                x.data_ptr(), g.data_ptr(), residual.data_ptr(),
                residual.numel(), (_PTR * len(ptrs))(*ptrs), dx.data_ptr(),
                dparams.data_ptr(), scratch.data_ptr(), partials.data_ptr(),
                dw_part.data_ptr(), n, c_widths, len(layers), rows, chunks,
                ACTIVATION_CODES[activation], int(use_norm),
                torch.cuda.current_stream().cuda_stream)
        _check_launch(lib, err, "K2")
        spans.count("launches.K2")
    else:
        dparams.zero_()
    return dx, grad_views(dparams, widths)


def autograd_records(tensors: Sequence[torch.Tensor]) -> bool:
    """Whether autograd records a call on `tensors`, and so may call its
    backward: grad mode on and some input needing a gradient. Inside
    ``FusedMLP.forward`` grad mode is always off, and
    ``ctx.needs_input_grad`` follows ``requires_grad`` alone, so it reads
    True under ``torch.no_grad`` too; hence the caller decides."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


class FusedMLP(torch.autograd.Function):
    """K1 forward, K2 backward. Inputs: ``x [N, F]``, the DNN's ``layers``
    (whose parameters the kernels read), the activation, ``use_norm``,
    whether K1 saves the residuals that K2 reads, then the flat parameter
    tensors that autograd differentiates."""

    @staticmethod
    def forward(ctx, x, layers, activation, use_norm, save, *params):
        ctx.layers, ctx.activation, ctx.use_norm = layers, activation, use_norm
        residual = new_residual(layers, x, use_norm) if save else None
        ctx.save_for_backward(x, residual)
        return mlp_forward(layers, x, activation, use_norm,
                           residual=residual)

    @staticmethod
    def backward(ctx, g):
        x, residual = ctx.saved_tensors
        dx, grads = mlp_backward(ctx.layers, x, g, ctx.activation,
                                 ctx.use_norm, residual=residual)
        return (dx, None, None, None, None, *grads)


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
    params = _flat_params(layers)
    save = x.is_cuda and autograd_records([x, *params])
    out = FusedMLP.apply(x, layers, activation, use_norm, save, *params)
    return out.reshape(features.shape[:-1])
