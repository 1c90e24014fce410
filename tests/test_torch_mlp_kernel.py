"""K1, the fused MLP forward: the port's wrapper against the JAX kernel.

On the CPU the port's ``fused_mlp_score`` runs its plain PyTorch version
(CPU tensors only); it is held to the JAX Pallas kernel run in interpret
mode, the way tests/test_pallas_kernels.py runs it. The CUDA kernels
themselves (K1, and K2 when the call is differentiated) are held to the
plain version on the card by the ``gpu`` tests below and by
``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

from ultra_pytorch_tpu_torch.models.dnn import DNN, params_from_jax
from ultra_pytorch_tpu_torch.ops.kernels import mlp
from ultra_pytorch_tpu_torch.utils import spans

# JAX is imported inside the tests that compare with it, so that the gpu
# tests also run on a machine with the card and no JAX.

F = 24
HIDDEN = "hidden_layer_sizes=[32, 16]"
TOL = 2e-5  # the tolerance of tests/test_pallas_kernels.py:28


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _jax_fused(params, x, activation="elu", use_norm=True):
    from ultra_pytorch_tpu.models.base import ACTIVATIONS
    from ultra_pytorch_tpu.ops.pallas.mlp import fused_mlp_score

    return np.asarray(fused_mlp_score(
        params["layers"], x, activation=ACTIVATIONS[activation],
        use_norm=use_norm, interpret=True))


@pytest.fixture(scope="module")
def pair():
    import jax

    from ultra_pytorch_tpu.models.dnn import DNN as JaxDNN

    params = JaxDNN(HIDDEN, F).init(jax.random.PRNGKey(0), F)
    params = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.default_rng(0)
    for layer in params["layers"]:
        n = layer["norm"]["scale"].shape[0]
        layer["norm"]["scale"] = (1 + 0.2 * rng.normal(size=n)).astype(
            np.float32)
        layer["norm"]["bias"] = (0.2 * rng.normal(size=n)).astype(np.float32)
    return params, params_from_jax(DNN(HIDDEN, F), params)


def _features(shape, seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("shape", [(6, 9, F), (13, F), (7, F), (600, F)],
                         ids=["3d", "2d", "7-unaligned-rows",
                              "600-rows-3-tiles"])
def test_matches_jax_kernel(pair, shape):
    params, model = pair
    x = _features(shape)
    want = _jax_fused(params, x)
    with torch.no_grad():
        got = mlp.fused_mlp_score(model.layers, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == shape[:-1]
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("activation", ["elu", "relu", "selu", "tanh",
                                        "sigmoid"])
@pytest.mark.parametrize("use_norm", [True, False])
def test_activation_and_norm_match_jax_kernel(pair, activation, use_norm):
    params, model = pair
    x = _features((2, 5, F), seed=2)
    want = _jax_fused(params, x, activation, use_norm)
    with torch.no_grad():
        got = mlp.fused_mlp_score(model.layers, torch.from_numpy(x),
                                  activation=activation,
                                  use_norm=use_norm).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_wrapper_checks_its_inputs(pair):
    _, model = pair
    with pytest.raises(TypeError, match="float32"):
        mlp.fused_mlp_score(model.layers, torch.zeros(3, F,
                                                      dtype=torch.float64))
    with pytest.raises(ValueError, match="layer widths"):
        mlp.fused_mlp_score(model.layers, torch.zeros(3, F + 1))
    with pytest.raises(ValueError, match="activation"):
        mlp.fused_mlp_score(model.layers, torch.zeros(3, F), "gelu")
    with pytest.raises(ValueError, match="no K1 kernel"):
        mlp.fused_mlp_score(model.layers, torch.zeros(3, F, device="meta"))


def test_cpu_path_never_launches(pair):
    _, model = pair
    before = spans.counters()["launches.K1"]
    with torch.no_grad():
        mlp.fused_mlp_score(model.layers, torch.zeros(4, F))
    assert spans.counters()["launches.K1"] == before


def test_autograd_records_only_where_a_backward_can_follow():
    """K1 saves the residuals for K2 only where autograd records the call:
    grad mode on and some input needing a gradient. Under no_grad and
    inference_mode (serving, validation) it saves nothing, although
    ctx.needs_input_grad would read True there."""
    model = DNN(HIDDEN, F, generator=torch.Generator().manual_seed(0))
    params = mlp._flat_params(model.layers)
    x = torch.zeros(3, F)
    assert mlp.autograd_records([x, *params])
    assert mlp.autograd_records([x.requires_grad_(True)])
    with torch.no_grad():
        assert not mlp.autograd_records([x, *params])
    with torch.inference_mode():
        assert not mlp.autograd_records([torch.zeros(3, F), *params])
    assert not mlp.autograd_records([torch.zeros(3, F)] + [
        p.detach() for p in params])


def test_cpu_path_keeps_no_residual(pair):
    """The plain version trains by autograd through the plain chain: no
    residual is made or counted, and K1's wrapper refuses one."""
    _, model = pair
    before = spans.counters()
    x = torch.from_numpy(_features((4, F))).requires_grad_(True)
    mlp.fused_mlp_score(model.layers, x).sum().backward()
    assert x.grad is not None and spans.counters() == before
    model.zero_grad()
    with pytest.raises(ValueError, match="no residual"):
        mlp.mlp_forward(model.layers, x.detach(), "elu", True,
                        residual=torch.zeros(1))


@pytest.mark.parametrize("use_norm", [True, False])
def test_residual_layout_at_the_training_widths(use_norm):
    """K1's residual at a training step's 2,560 rows of the widths 136,
    512, 256, 128, 1: post of every layer, and with LayerNorm h past the
    first and a mean and rstd a row and layer; 19.8 MB."""
    widths = (136, 512, 256, 128, 1)
    layout, total = mlp.residual_layout(widths, 2560, use_norm)
    ins = widths[:-1]
    per_row = sum(ins) + ((sum(ins[1:]) + 2 * len(ins)) if use_norm else 0)
    assert total == 2560 * per_row
    if use_norm:
        assert per_row == 1936 and 4 * total == 19_824_640
    spans = sorted((off, off + int(np.prod(shape))) for layer in layout
                   for off, shape in layer.values())
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert [sorted(layer) for layer in layout] == (
        [["mean", "post", "rstd"]] + [["h", "mean", "post", "rstd"]] * 3
        if use_norm else [["post"]] * 4)


def test_residual_parts_start_on_16_bytes():
    """Odd rows and widths: every part starts on 16 bytes, as K2's
    vector loads of post need."""
    layout, total = mlp.residual_layout((37, 300, 70, 5, 1), 77, True)
    offsets = [off for layer in layout for off, _ in layer.values()]
    assert all(off % 4 == 0 for off in offsets) and total % 4 == 0
    assert total >= sum(int(np.prod(shape)) for layer in layout
                        for _, shape in layer.values())


@pytest.mark.parametrize("activation", ["elu", "sigmoid"])
@pytest.mark.parametrize("use_norm", [True, False])
def test_plain_residual_holds_the_chain(activation, use_norm):
    """The plain version of K1's saving mode: each layer's input, its
    LayerNorm statistics and output, from which the next layer's input
    and the scores follow."""
    from ultra_pytorch_tpu_torch.models.base import ACTIVATIONS

    model, gen = seeded_dnn(HIDDEN, F, 4)
    x = torch.randn(13, F, generator=gen)
    widths = mlp._widths(model.layers)
    views = mlp.residual_views(mlp.mlp_residual_reference(
        model.layers, x, activation, use_norm), widths, 13, use_norm)
    h = x
    with torch.no_grad():
        for j, (part, layer) in enumerate(zip(views, model.layers)):
            if use_norm:
                if j:
                    torch.testing.assert_close(part["h"], h)
                post = ((h - part["mean"][:, None]) * part["rstd"][:, None]
                        * layer.norm.weight + layer.norm.bias)
                torch.testing.assert_close(part["post"], post)
            else:
                assert torch.equal(part["post"], h)
            h = part["post"] @ layer.linear.weight.t() + layer.linear.bias
            if j != len(model.layers) - 1:
                h = ACTIVATIONS[activation](h)
        torch.testing.assert_close(h[:, 0], mlp.fused_mlp_score_reference(
            model.layers, x, activation, use_norm))


def test_packed_params_follow_parameter_updates():
    """The kernels read the parameters in place: the pointer table holds
    each layer's LayerNorm scale, bias, nn.Linear weight [out, in] and bias,
    so an optimizer step's in-place update needs no repacking, and a
    replaced tensor shows up on the next call."""
    model = DNN(HIDDEN, F, generator=torch.Generator().manual_seed(0))
    cpu = torch.device("cpu")
    first = mlp._param_pointers(model.layers, cpu)
    want = [t.data_ptr() for layer in model.layers
            for t in (layer.norm.weight, layer.norm.bias,
                      layer.linear.weight, layer.linear.bias)]
    assert first == want
    assert len(first) == 4 * len(model.layers)
    assert tuple(model.layers[1].linear.weight.shape) == (16, 32)  # [out, in]
    with torch.no_grad():
        model.layers[0].linear.weight.mul_(2.0)
    assert mlp._param_pointers(model.layers, cpu) == first
    model.layers[0].linear.weight = torch.nn.Parameter(
        model.layers[0].linear.weight.detach().clone())
    again = mlp._param_pointers(model.layers, cpu)
    assert again[2] != first[2] and again[:2] + again[3:] == \
        first[:2] + first[3:]


def test_param_pointers_refuse_what_the_kernels_cannot_read():
    model = DNN(HIDDEN, F, generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="contiguous float32"):
        mlp._param_pointers(model.layers, torch.device("meta"))
    model.layers[0].linear.weight = torch.nn.Parameter(
        model.layers[0].linear.weight.detach().double())
    with pytest.raises(ValueError, match="contiguous float32"):
        mlp._param_pointers(model.layers, torch.device("cpu"))
    model.layers[0].linear.weight = torch.nn.Parameter(
        torch.zeros(F, 32).t())  # [32, F] but not contiguous
    with pytest.raises(ValueError, match="contiguous float32"):
        mlp._param_pointers(model.layers, torch.device("cpu"))


def _smem(limit_rows):
    """A shared-memory query under which tiles above `limit_rows` rows do
    not fit."""
    return lambda rows: 1000 if rows <= limit_rows else mlp.SMEM_LIMIT + 1


@pytest.mark.parametrize("n_rows,rows", [
    (1, 16), (1000, 16), (2112, 16), (2113, 32), (2560, 32), (4224, 32),
    (6000, 64), (8448, 64), (10000, 32), (12800, 64), (25600, 32),
    (30720, 64), (32768, 64)])
def test_rows_per_block_balances_the_card(n_rows, rows):
    """The tile that leaves the busiest of 132 SMs the least work (its
    waves times rows plus a tile's fixed cost), the larger on a tie: 2,560
    rows (a training step) run 80 32-row blocks, not 160 16-row ones of
    which 28 SMs would take two; 30,720 rows (the online lists) 480 64-row
    blocks, not 1,920 16-row ones (15 waves of cheaper tiles); 32,768 rows
    (the 256x128 serving bucket) 512 64-row blocks. At 6,000, 10,000,
    12,800 and 25,600 rows the tile's cost moves the choice from 16-row
    tiles to 64 or 32 (timed by torch_mlp_probe.py)."""
    assert mlp.rows_per_block(n_rows, 132, _smem(64)) == rows


@pytest.mark.parametrize("n_rows,rows", [
    (128, 16), (1000, 16), (2560, 32), (10000, 32), (12800, 32),
    (25600, 32), (30720, 32), (32768, 32)])
def test_k2_rows_per_block_takes_no_64_row_tile(n_rows, rows):
    """K2 on K1's residual chooses between 32- and 16-row tiles: where K1
    takes 64-row tiles (12,800, 30,720 and 32,768 rows), K2 takes 32-row
    ones, which ran it 3% faster there (torch_mlp_probe.py)."""
    assert mlp.rows_per_block(n_rows, 132, _smem(64),
                              mlp.K2_ROWS_PER_BLOCK) == rows


def test_rows_per_block_skips_tiles_that_do_not_fit():
    assert mlp.rows_per_block(32768, 132, _smem(32)) == 32
    assert mlp.rows_per_block(32768, 132, _smem(16)) == 16
    assert mlp.rows_per_block(8448, 132, lambda rows: 0 if rows == 64
                              else 1000) == 32
    with pytest.raises(ValueError, match="shared memory"):
        mlp.rows_per_block(32768, 132, _smem(8))


DNN_WIDTHS = (136, 512, 256, 128, 1)


@pytest.mark.parametrize("n_rows", [30720, 32768])
def test_wgmma_instance_scores_the_online_lists(n_rows):
    """K1 without a residual on 64-row tiles at the DNN's widths runs its
    wgmma instance: the online learners' whole lists (256 x 120) and the
    256x128 serving bucket."""
    rows = mlp.rows_per_block(n_rows, 132, _smem(64))
    assert rows == mlp.WG_ROWS
    assert mlp.takes_wgmma(rows, False, DNN_WIDTHS)


@pytest.mark.parametrize("n_rows,saving,widths,smem", [
    (2560, False, DNN_WIDTHS, _smem(64)),      # a training step: 32 rows
    (128, False, DNN_WIDTHS, _smem(64)),       # a small bucket: 16 rows
    (30720, True, DNN_WIDTHS, _smem(64)),      # saving K2's residual
    (32768, True, DNN_WIDTHS, _smem(64)),
    (7680, False, (700, 512, 256, 128, 1), _smem(16)),   # F = 700
    (30720, False, (700, 512, 256, 128, 1), _smem(64)),  # its buffer
    (30720, False, (136, 1024, 1), _smem(64)),  # wider than 2 x 256
])
def test_wgmma_instance_is_not_taken(n_rows, saving, widths, smem):
    """The mma.sync instances stay where a residual is saved, where
    rows_per_block picks 16- or 32-row tiles, and where the wgmma
    instance's shared memory does not fit the widths."""
    rows = mlp.rows_per_block(n_rows, 132, smem)
    assert not mlp.takes_wgmma(rows, saving, widths)


def test_wgmma_shared_memory_at_the_dnn_widths():
    """Three 32 KB weight stages, one 64-row buffer of the widest layer
    input (width 512, row stride 516) and six barriers: 230,448 bytes of
    the 232,448 a block has."""
    assert mlp.wg_smem_bytes(DNN_WIDTHS) == (
        3 * 32768 + 4 * 64 * 516 + 48) == 230448
    assert mlp.wg_smem_bytes((220, 512, 256, 128, 1)) == 230448
    assert mlp.wg_smem_bytes((700, 512, 256, 128, 1)) > mlp.SMEM_LIMIT
    assert mlp.wg_smem_bytes((136, 513, 1)) == 0
    assert 0 < mlp.wg_smem_bytes((37, 300, 70, 5, 1)) <= mlp.SMEM_LIMIT


def test_dw_tiles_and_chunks():
    """K2's dW phase: 64x64 tiles of every layer's [out, in] gradient, and
    row chunks enough for four blocks per SM, none shorter than a stage."""
    widths = (136, 512, 256, 128, 1)
    assert mlp.dw_tiles(widths) == 8 * 3 + 4 * 8 + 2 * 4 + 1 * 2 == 66
    assert mlp.dw_chunks(2560, widths, 132) == 8     # 528 blocks
    assert mlp.dw_chunks(32768, widths, 132) == 8
    assert mlp.dw_chunks(100, widths, 132) == 4      # 32-row stages
    assert mlp.dw_chunks(1, widths, 132) == 1
    assert mlp.dw_chunks(2560, widths, 132, per_sm=2) == 4   # 264 blocks
    assert mlp.dw_tiles((37, 300, 70, 5, 1)) == 5 * 1 + 2 * 5 + 1 * 2 + 1


def test_grad_views_follow_the_kernel_layout():
    """K2 writes per layer [dscale, dbias, dW [out, in], db] into one
    buffer; the views are nn.Linear-shaped and cover it exactly."""
    widths = (3, 4, 1)
    dparams = torch.arange(3 + 3 + 12 + 4 + 4 + 4 + 4 + 1, dtype=torch.float32)
    grads = mlp.grad_views(dparams, widths)
    assert [tuple(g.shape) for g in grads] == [(3,), (3,), (4, 3), (4,),
                                               (4,), (4,), (1, 4), (1,)]
    assert grads[2].is_contiguous()
    assert grads[2][1, 0].item() == 6 + 3     # row o = 1 starts after 3 ins
    assert grads[3][0].item() == 18
    assert grads[-1].item() == dparams[-1].item()


def test_build_hash_follows_included_headers(tmp_path):
    """A header that a kernel includes is part of its build's name, so an
    edited shared header never loads a stale library."""
    from ultra_pytorch_tpu_torch.ops.kernels import build

    (tmp_path / "common.cuh").write_text("// v1\n")
    (tmp_path / "inner.cuh").write_text("#include \"common.cuh\"\n")
    src = tmp_path / "k.cu"
    src.write_text('#include <cuda_runtime.h>\n#include "inner.cuh"\n')
    assert build.with_headers([src]) == [src, tmp_path / "inner.cuh",
                                         tmp_path / "common.cuh"]
    before = build.library_path("k", [src])
    assert build.library_path("k", [src]) == before
    (tmp_path / "common.cuh").write_text("// v2\n")
    assert build.library_path("k", [src]) != before
    assert build.library_path("k", [src]).parent == build.BUILD_DIR


def test_k1_and_k2_share_their_header():
    from ultra_pytorch_tpu_torch.ops.kernels import build

    for source in (mlp.SOURCE, mlp.BWD_SOURCE):
        assert build.CSRC_DIR / "mlp_common.cuh" in build.with_headers(
            [source])


def seeded_dnn(hparams, features, seed, device="cpu"):
    """A DNN with torch-default init from `seed`, a LayerNorm affine away
    from its init, and the generator to draw inputs from."""
    gen = torch.Generator().manual_seed(seed)
    model = DNN(hparams, features, generator=gen)
    with torch.no_grad():
        for layer in model.layers:
            n = layer.norm.weight.shape[0]
            layer.norm.weight.add_(0.1 * torch.randn(n, generator=gen))
            layer.norm.bias.add_(0.1 * torch.randn(n, generator=gen))
    return model.to(device), gen


def float64_grads(layers, x, g, activation, use_norm, matmul=torch.matmul):
    """Scores, then dx and the parameter gradients (``_flat_params``
    order), of the fused MLP by autograd in float64 with the same clamped
    one-pass variance: the exact answer that K1/K2 and their float32 plain
    versions both approximate. `matmul(a, b)` takes every product."""
    from ultra_pytorch_tpu_torch.models.base import ACTIVATIONS

    params = [p.detach().double().requires_grad_(True)
              for p in mlp._flat_params(layers)]
    xr = x.detach().double().requires_grad_(True)
    with torch.enable_grad():
        h = xr
        for j in range(len(layers)):
            scale, bias, w, b = params[4 * j: 4 * j + 4]
            if use_norm:
                mean = h.mean(-1, keepdim=True)
                var = (h * h).mean(-1, keepdim=True) - mean * mean
                h = ((h - mean) * torch.rsqrt(var.clamp_min(0.0) + 1e-5)
                     * scale + bias)
            h = matmul(h, w.t()) + b
            if j != len(layers) - 1:
                h = ACTIVATIONS[activation](h)
        grads = torch.autograd.grad(h[:, 0], [xr] + params, g.double(),
                                    allow_unused=True)
    return h[:, 0].detach(), [torch.zeros_like(t) if d is None else d
                              for t, d in zip([xr] + params, grads)]


def off_float64(got, exact):
    """Worst over the tensors of max abs error / the float64 tensor's
    largest magnitude."""
    return max((a.double() - b).abs().max().item()
               / max(b.abs().max().item(), 1e-12) for a, b in zip(got, exact))


# The odd widths with sigmoid and LayerNorm: the LayerNorm over 5 sigmoid
# outputs near 0.5 amplifies float32 rounding (the K1/K2 witness case).
WITNESS = ("hidden_layer_sizes=[300, 70, 5]", 37, "sigmoid", True)


def _rna_tf32(x):
    """mlp_common.cuh ``rna_tf32`` on float32 values: add half of the 13
    dropped bits' range to the magnitude, then clear them."""
    bits = x.float().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split_tf32(x):
    """mlp_common.cuh ``split_tf32``: x = hi + lo, both TF32 (as float64)."""
    x32 = x.float()
    hi = _rna_tf32(x32)
    return hi.double(), _rna_tf32(x32 - hi).double()


def _mm_3xtf32(a, b):
    """a @ b as the kernels take it: float32 operands split into TF32 parts
    and three of the four part products (a_lo*b_lo dropped), each exact and
    summed in float64, so only the split's error is left."""
    ah, al = _split_tf32(a)
    bh, bl = _split_tf32(b)
    return al @ bh + ah @ bl + ah @ bh


class _Matmul3xTF32(torch.autograd.Function):
    """The forward's h @ W^T and K2's two backward products (dz @ W and
    dz^T @ post), all through ``_mm_3xtf32``."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _mm_3xtf32(a, b)

    @staticmethod
    def backward(ctx, grad):
        a, b = ctx.saved_tensors
        return _mm_3xtf32(grad, b.t()), _mm_3xtf32(a.t(), grad)


@pytest.mark.parametrize("hparams,features,activation,use_norm,n_rows", [
    WITNESS + (1000,), WITNESS + (2559,), WITNESS + (2560,),
    ("hidden_layer_sizes=[512, 256, 128]", 136, "elu", True, 512)])
def test_3xtf32_split_keeps_float32_accuracy(hparams, features, activation,
                                             use_norm, n_rows):
    """The 3xTF32 split of every product that K1 and K2 take, emulated
    exactly (the kernels' integer rounding), moves the gradients from
    float64 by under 1e-5 of their largest magnitude, 20 times below the
    2e-4 that K2 is held to. So where K2 and the float32 plain version
    differ by more (the witness case, in test_torch_kernels_gpu.py), the
    rest of float32 arithmetic, not the split, is what moved them."""
    model, gen = seeded_dnn(hparams, features, n_rows)
    x = torch.randn(n_rows, features, generator=gen)
    g = torch.randn(n_rows, generator=gen)
    _, exact = float64_grads(model.layers, x, g, activation, use_norm)
    _, split = float64_grads(model.layers, x, g, activation, use_norm,
                             _Matmul3xTF32.apply)
    assert off_float64(split, exact) <= 1e-5


def test_split_tf32_rounds_as_the_kernel():
    """hi keeps 10 mantissa bits, rounded to nearest with ties away from
    zero; hi + lo carries x to 2^-22 of its magnitude."""
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -12, -3.0e-7,
                      123.456, -0.1])
    hi, lo = _split_tf32(x)
    assert hi[0] == 1.0 and lo[0] == 0.0
    assert hi[1] == 1.0 + 2.0 ** -10      # a tie rounds away from zero
    assert hi[2] == 1.0
    assert torch.all(_rna_tf32(hi.float()) == hi.float())
    assert torch.all(_rna_tf32(lo.float()) == lo.float())
    assert torch.all((hi + lo - x.double()).abs()
                     <= 2.0 ** -22 * x.double().abs())


def kink_free_rows(model, x, activation, use_norm, eps=1e-5):
    """1.0 for the rows none of whose hidden pre-activations lies within
    `eps` of 0, else 0.0; all ones for activations whose derivative is
    continuous. relu's and selu's derivatives jump at 0, so at a
    pre-activation within float32 rounding of 0 the two versions may take
    different sides and both be right; those rows get a zero cotangent."""
    keep = torch.ones(x.shape[0], dtype=torch.float32, device=x.device)
    if activation not in ("relu", "selu"):
        return keep
    act = {"relu": torch.relu, "selu": torch.selu}[activation]
    h = x.double()
    for j, layer in enumerate(model.layers[:-1]):
        if use_norm:
            mean = h.mean(-1, keepdim=True)
            var = (h * h).mean(-1, keepdim=True) - mean * mean
            h = ((h - mean) * torch.rsqrt(var.clamp_min(0.0) + 1e-5)
                 * layer.norm.weight.double() + layer.norm.bias.double())
        z = h @ layer.linear.weight.double().t() + layer.linear.bias.double()
        keep = keep * (z.abs() > eps).all(dim=1)
        h = act(z)
    assert keep.mean().item() >= 0.9
    return keep


@pytest.mark.gpu
@pytest.mark.parametrize("n_rows", [1, 15, 17, 31, 63, 65, 1000, 2559, 2560,
                                    4096, 32768])
@pytest.mark.parametrize("activation,use_norm", [("elu", True),
                                                 ("relu", False),
                                                 ("selu", True),
                                                 ("tanh", True),
                                                 ("sigmoid", False)])
def test_kernel_matches_plain_version_on_card(n_rows, activation, use_norm):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K1 has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(n_rows)
    model = DNN("hidden_layer_sizes=[512, 256, 128]", 136,
                generator=gen).cuda()
    x = torch.randn(n_rows, 136, generator=gen).cuda()
    before = spans.counters()["launches.K1"]
    with torch.inference_mode():
        got = mlp.fused_mlp_score(model.layers, x, activation, use_norm)
        ref = mlp.fused_mlp_score_reference(model.layers, x, activation,
                                            use_norm)
    torch.cuda.synchronize()
    assert spans.counters()["launches.K1"] == before + 1
    # Sums over K <= 512 taken in another order than cuBLAS's.
    torch.testing.assert_close(got, ref, rtol=2e-4, atol=2e-4)
    # With gradients on, the same call trains through K2; its gradients
    # are held to autograd of the plain version (sums over rows in
    # another order, so relative to the largest gradient).
    g = torch.randn(n_rows, generator=gen).cuda() * kink_free_rows(
        model, x, activation, use_norm)
    k2 = spans.counters()["launches.K2"]
    xg = x.clone().requires_grad_(True)
    mlp.fused_mlp_score(model.layers, xg, activation, use_norm).backward(g)
    assert spans.counters()["launches.K2"] == k2 + 1
    got_grads = [xg.grad] + [p.grad for p in model.parameters()]
    model.zero_grad()
    xr = x.clone().requires_grad_(True)
    mlp.fused_mlp_score_reference(model.layers, xr, activation,
                                  use_norm).backward(g)
    for a, b in zip(got_grads, [xr.grad] + [p.grad for p in
                                            model.parameters()]):
        if b is None:  # a LayerNorm affine without use_norm: K2 gives 0
            assert not a.any()
            continue
        scale = max(b.abs().max().item(), 1e-6)
        err = (a - b).abs().max().item()
        assert err <= 2e-4 * scale, (tuple(b.shape), err, scale)


@pytest.mark.gpu
def test_kernel_odd_widths_on_card():
    """Widths that are no multiple of 4 (the scalar k loop) and wider than
    one 256-column pass, over a ragged last tile."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K1 has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(5)
    model = DNN("hidden_layer_sizes=[300, 70, 5]", 37, generator=gen).cuda()
    x = torch.randn(77, 37, generator=gen).cuda()
    with torch.inference_mode():
        got = mlp.fused_mlp_score(model.layers, x, "elu", True)
        ref = mlp.fused_mlp_score_reference(model.layers, x, "elu", True)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, rtol=2e-4, atol=2e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("n_rows", [2560, 32768])
def test_kernel_is_deterministic_on_card(n_rows):
    """Two runs of K1 on the same inputs give the same bits (every sum is
    taken in a fixed order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K1 has no CPU mode)")
    gen = torch.Generator().manual_seed(3)
    model = DNN("hidden_layer_sizes=[512, 256, 128]", 136,
                generator=gen).cuda()
    x = torch.randn(n_rows, 136, generator=gen).cuda()
    with torch.inference_mode():
        first = mlp.fused_mlp_score(model.layers, x)
        again = mlp.fused_mlp_score(model.layers, x)
    assert torch.equal(first, again)


@pytest.mark.gpu
def test_kernel_tiles_fit_the_card():
    """At the full widths the caller picks K1's 32-row tiles for a
    training step and 64-row tiles for the online lists and the serving
    bucket, K2's 32-row tiles for all three, and every tile fits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K1 has no CPU mode)")
    lib, _ = mlp._library()
    widths = mlp._c_ints((136, 512, 256, 128, 1))
    sms = mlp._sm_count(torch.device("cuda"))
    smem = lambda rows: lib.ultra_mlp_fwd_smem_bytes(widths, 4, rows)
    assert mlp.rows_per_block(2560, sms, smem) == 32
    assert mlp.rows_per_block(30720, sms, smem) == 64
    assert mlp.rows_per_block(32768, sms, smem) == 64
    assert all(0 < smem(r) <= mlp.SMEM_LIMIT for r in mlp.ROWS_PER_BLOCK)
    for n in (2560, 30720, 32768):   # K2: 32-row tiles
        assert mlp._bwd_plan((136, 512, 256, 128, 1), n, sms)[0] == 32


# (rows, features, rows a block) of K1's saving mode on the card: the
# smallest serving bucket, a training step and the online lists with each
# tile instance, and bench_exp at F = 700 with the one that fits there (a
# 32-row tile of 700 features needs 267 KB of shared memory, more than
# the 227 KB a block has).
SAVING_CASES = [(n, 136, rows) for n in (128, 2560, 30720)
                for rows in mlp.ROWS_PER_BLOCK] + [(7680, 700, 16)]


@pytest.mark.gpu
@pytest.mark.parametrize("n_rows,features,rows", SAVING_CASES)
def test_saving_changes_no_score_on_card(n_rows, features, rows):
    """K1 with a residual buffer gives the same bits as without, for each
    tile instance, and its residual holds the plain chain's
    intermediates."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K1 has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    model, gen = seeded_dnn("hidden_layer_sizes=[512, 256, 128]", features,
                            n_rows, "cuda")
    x = torch.randn(n_rows, features, generator=gen).cuda()
    residual = mlp.new_residual(model.layers, x, True)
    with torch.inference_mode():
        plain = mlp.mlp_forward(model.layers, x, "elu", True, _rows=rows)
        saving = mlp.mlp_forward(model.layers, x, "elu", True, _rows=rows,
                                 residual=residual)
        want = mlp.mlp_residual_reference(model.layers, x, "elu", True)
    torch.cuda.synchronize()
    assert torch.equal(plain, saving)
    widths = mlp._widths(model.layers)
    for got, ref in zip(mlp.residual_views(residual, widths, n_rows, True),
                        mlp.residual_views(want, widths, n_rows, True)):
        for name in ref:
            torch.testing.assert_close(got[name], ref[name], rtol=2e-4,
                                       atol=2e-4, msg=name)


@pytest.mark.gpu
@pytest.mark.parametrize("activation,use_norm", [
    ("elu", True), ("relu", False), ("selu", True), ("tanh", False),
    ("sigmoid", True)])
def test_saved_residual_matches_plain_chain_on_card(activation, use_norm):
    """Every activation, with and without LayerNorm, over odd widths and a
    ragged last tile: the saved parts against the plain chain's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K1 has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    model, gen = seeded_dnn("hidden_layer_sizes=[300, 70, 5]", 37, 9,
                            "cuda")
    x = torch.randn(1000, 37, generator=gen).cuda()
    residual = mlp.new_residual(model.layers, x, use_norm)
    with torch.inference_mode():
        scores = mlp.mlp_forward(model.layers, x, activation, use_norm,
                                 residual=residual)
        want = mlp.mlp_residual_reference(model.layers, x, activation,
                                          use_norm)
        ref = mlp.fused_mlp_score_reference(model.layers, x, activation,
                                            use_norm)
    torch.cuda.synchronize()
    torch.testing.assert_close(scores, ref, rtol=2e-4, atol=2e-4)
    widths = mlp._widths(model.layers)
    for got, exp in zip(mlp.residual_views(residual, widths, 1000, use_norm),
                        mlp.residual_views(want, widths, 1000, use_norm)):
        assert sorted(got) == sorted(exp)
        for name in exp:
            torch.testing.assert_close(got[name], exp[name], rtol=2e-4,
                                       atol=2e-4, msg=name)


@pytest.mark.gpu
def test_no_grad_scores_save_nothing_on_card():
    """Under no_grad and inference_mode K1 launches without a residual;
    with gradients on, each forward saves one and its backward reads it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K1 has no CPU mode)")
    model, gen = seeded_dnn(HIDDEN, F, 3, "cuda")
    x = torch.randn(4, 16, F, generator=gen).cuda()
    before = spans.counters()
    names = ("launches.K1", "launches.K1_saved", "launches.K2")

    def counted():
        after = spans.counters()
        return tuple(after[k] - before[k] for k in names)

    with torch.no_grad():
        mlp.fused_mlp_score(model.layers, x)
    with torch.inference_mode():
        mlp.fused_mlp_score(model.layers, x)
    assert counted() == (2, 0, 0)
    mlp.fused_mlp_score(model.layers, x).sum().backward()
    assert counted() == (3, 1, 1)


@pytest.mark.gpu
def test_kernel_refuses_other_dtypes_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K1 has no CPU mode)")
    model = DNN("hidden_layer_sizes=[32, 16]", F).cuda()
    with pytest.raises(ValueError, match="float32"):
        mlp.mlp_forward(model.layers, torch.zeros(3, F, device="cuda",
                                                  dtype=torch.float64),
                        "elu", True)
    with pytest.raises(ValueError, match="contiguous"):
        mlp.mlp_forward(model.layers, torch.zeros(F, 3, device="cuda").t(),
                        "elu", True)
