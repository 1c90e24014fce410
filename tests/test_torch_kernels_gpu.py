"""K1's wgmma instance and K2-K5 on the card against their plain PyTorch
versions.

These need a CUDA device (the kernels have no CPU mode) and skip without
one. The file imports nothing of JAX, so it runs on a machine with the
card and no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_*.py -q
"""

import pytest
import torch

from ultra_pytorch_tpu_torch.models.dnn import DNN
from ultra_pytorch_tpu_torch.ops import losses
from ultra_pytorch_tpu_torch.ops.kernels import click_sim, listwise_loss, mlp
from ultra_pytorch_tpu_torch.utils import spans

from test_torch_mlp_kernel import (WITNESS, float64_grads, kink_free_rows,
                                   off_float64, seeded_dnn)

pytestmark = pytest.mark.gpu

FULL = "hidden_layer_sizes=[512, 256, 128]"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, ref, rtol):
    """Within rtol of the reference's largest magnitude: sums over rows
    taken in another order (per tile in K2, blocked in cuBLAS)."""
    scale = max(ref.abs().max().item(), 1e-6)
    err = (got - ref).abs().max().item()
    assert err <= rtol * scale, f"max abs err {err:.3e} vs scale {scale:.3e}"


def _seeded_dnn(hparams, features, seed, device):
    gen = torch.Generator().manual_seed(seed)
    model = DNN(hparams, features, generator=gen)
    with torch.no_grad():
        for layer in model.layers:
            n = layer.norm.weight.shape[0]
            layer.norm.weight.add_(0.1 * torch.randn(n, generator=gen))
            layer.norm.bias.add_(0.1 * torch.randn(n, generator=gen))
    return model.to(device), gen


@pytest.mark.parametrize("n_rows", [1, 15, 17, 31, 63, 65, 1000, 2559, 2560,
                                    32768])
@pytest.mark.parametrize("activation,use_norm", [("elu", True),
                                                 ("elu", False),
                                                 ("tanh", True),
                                                 ("sigmoid", False)])
def test_k2_matches_autograd_of_plain_version(cuda, n_rows, activation,
                                              use_norm):
    """Activations with a continuous derivative; relu and selu, whose
    derivatives jump at 0, are held to the plain version in
    test_torch_mlp_kernel.py away from the jump."""
    model, gen = _seeded_dnn(FULL, 136, n_rows, cuda)
    x = torch.randn(n_rows, 136, generator=gen).to(cuda)
    g = torch.randn(n_rows, generator=gen).to(cuda)
    before = spans.counters()["launches.K2"]
    dx, grads = mlp.mlp_backward(model.layers, x, g, activation, use_norm)
    ref_dx, ref_grads = mlp.mlp_backward_reference(model.layers, x, g,
                                                   activation, use_norm)
    torch.cuda.synchronize()
    assert spans.counters()["launches.K2"] == before + 1
    _close(dx, ref_dx, 2e-4)
    for got, ref in zip(grads, ref_grads):
        assert got.shape == ref.shape
        _close(got, ref, 2e-4)


def test_k2_odd_widths(cuda):
    """Widths that are no multiple of 4 (the scalar k loop), wider than one
    256-column pass, over a ragged last tile."""
    model, gen = _seeded_dnn("hidden_layer_sizes=[300, 70, 5]", 37, 5, cuda)
    x = torch.randn(77, 37, generator=gen).to(cuda)
    g = torch.randn(77, generator=gen).to(cuda)
    dx, grads = mlp.mlp_backward(model.layers, x, g, "elu", True)
    ref_dx, ref_grads = mlp.mlp_backward_reference(model.layers, x, g,
                                                   "elu", True)
    torch.cuda.synchronize()
    for got, ref in zip([dx] + grads, [ref_dx] + ref_grads):
        assert got.shape == ref.shape
        _close(got, ref, 2e-4)


@pytest.mark.parametrize("n_rows", [1000, 2559, 2560, 32768])
def test_k1_k2_ill_conditioned_layer_norm_against_float64(cuda, n_rows):
    """The odd widths with sigmoid and LayerNorm: the LayerNorm over 5
    sigmoid outputs near 0.5 amplifies float32 rounding, so two float32
    computations of these gradients may differ by more than 2e-4 of the
    largest magnitude (K2 and the plain version by 2.3e-4 at 2,559 rows on
    an H100). The float64 gradient is the witness: K2 lies within 2e-4 of
    it, and no more than twice as far from it as the float32 plain
    version (the 3xTF32 split's own share is below 1e-5:
    test_3xtf32_split_keeps_float32_accuracy). K1 keeps its 2e-4 against
    the plain version."""
    hparams, features, activation, use_norm = WITNESS
    model, gen = seeded_dnn(hparams, features, n_rows, cuda)
    x = torch.randn(n_rows, features, generator=gen).to(cuda)
    g = torch.randn(n_rows, generator=gen).to(cuda)
    dx, grads = mlp.mlp_backward(model.layers, x, g, activation, use_norm)
    ref_dx, ref_grads = mlp.mlp_backward_reference(model.layers, x, g,
                                                   activation, use_norm)
    with torch.inference_mode():
        got = mlp.fused_mlp_score(model.layers, x, activation, use_norm)
        ref = mlp.fused_mlp_score_reference(model.layers, x, activation,
                                            use_norm)
    _, exact = float64_grads(model.layers, x, g, activation, use_norm)
    torch.cuda.synchronize()
    k2_off = off_float64([dx] + grads, exact)
    plain_off = off_float64([ref_dx] + ref_grads, exact)
    assert k2_off <= 2e-4, (k2_off, plain_off)
    assert k2_off <= 2 * plain_off, (k2_off, plain_off)
    torch.testing.assert_close(got, ref, rtol=2e-4, atol=2e-4)


def test_k2_is_deterministic_and_trains_through_autograd(cuda):
    model, gen = _seeded_dnn(FULL, 136, 7, cuda)
    x = torch.randn(4, 640, 136, generator=gen).to(cuda)
    first = mlp.mlp_backward(model.layers, x.reshape(-1, 136),
                             torch.ones(2560, device=cuda), "elu", True)
    again = mlp.mlp_backward(model.layers, x.reshape(-1, 136),
                             torch.ones(2560, device=cuda), "elu", True)
    for a, b in zip([first[0]] + first[1], [again[0]] + again[1]):
        assert torch.equal(a, b)
    before = spans.counters()
    (mlp.fused_mlp_score(model.layers, x) ** 2).sum().backward()
    after = spans.counters()
    assert (after["launches.K1"], after["launches.K2"]) == (
        before["launches.K1"] + 1, before["launches.K2"] + 1)
    got = [p.grad.clone() for p in model.parameters()]
    model.zero_grad()
    (mlp.fused_mlp_score_reference(model.layers, x) ** 2).sum().backward()
    for a, p in zip(got, model.parameters()):
        _close(a, p.grad, 2e-4)


def test_k2_workspace_follows_rows_and_chunks(cuda):
    """K2's scratch holds dz of every layer for N rows (post and h are
    K1's residual); its partials one row per block; its dW partials one
    gradient a chunk."""
    lib, _ = mlp._bwd_library()
    widths = (136, 512, 256, 128, 1)
    c_widths = mlp._c_ints(widths)
    n = 2560
    scratch, partials, dw, smem = mlp._bwd_workspace(lib, c_widths, 4, n, 16,
                                                     8)
    ins, outs = widths[:-1], widths[1:]
    assert scratch == n * sum(outs)
    assert 4 * scratch == 9_185_280
    assert partials == (n // 16) * sum(2 * i + o for i, o in zip(ins, outs))
    assert dw == 8 * sum(i * o for i, o in zip(ins, outs))
    assert 0 < smem <= mlp.SMEM_LIMIT
    assert mlp._bwd_workspace(lib, c_widths, 4, n, 24, 8) is None


@pytest.mark.parametrize("activation,use_norm", [
    ("elu", True), ("relu", True), ("selu", True), ("tanh", True),
    ("sigmoid", True), ("elu", False)])
def test_k2_from_k1_residual_against_float64(cuda, activation, use_norm):
    """K2 fed by what K1 saved, every activation code and one run without
    LayerNorm, at a training step's rows: within K2's 2e-4 of the float64
    backward (rows at relu's and selu's kink take a zero cotangent)."""
    model, gen = _seeded_dnn(FULL, 136, 11, cuda)
    x = torch.randn(2560, 136, generator=gen).to(cuda)
    g = torch.randn(2560, generator=gen).to(cuda) * kink_free_rows(
        model, x, activation, use_norm)
    residual = mlp.new_residual(model.layers, x, use_norm)
    with torch.inference_mode():
        mlp.mlp_forward(model.layers, x, activation, use_norm,
                        residual=residual)
    k2 = spans.counters()["launches.K2"]
    dx, grads = mlp.mlp_backward(model.layers, x, g, activation, use_norm,
                                 residual=residual)
    _, exact = float64_grads(model.layers, x, g, activation, use_norm)
    torch.cuda.synchronize()
    assert spans.counters()["launches.K2"] == k2 + 1
    assert off_float64([dx] + grads, exact) <= 2e-4


@pytest.mark.parametrize("n_rows,features", [(2560, 136), (30720, 136),
                                             (2560, 220), (7680, 700)])
def test_autograd_gradients_equal_direct_k2(cuda, n_rows, features):
    """Gradients through fused_mlp_score (K1 saving, then K2 on its
    residual) equal a direct mlp_backward (which runs K1 saving itself)
    bit for bit."""
    model, gen = _seeded_dnn(FULL, features, n_rows, cuda)
    x = torch.randn(n_rows, features, generator=gen).to(cuda)
    g = torch.randn(n_rows, generator=gen).to(cuda)
    saved = spans.counters()["launches.K1_saved"]
    xg = x.clone().requires_grad_(True)
    mlp.fused_mlp_score(model.layers, xg).backward(g)
    got = [xg.grad] + [p.grad for p in mlp._flat_params(model.layers)]
    dx, grads = mlp.mlp_backward(model.layers, x, g, "elu", True)
    torch.cuda.synchronize()
    assert spans.counters()["launches.K1_saved"] == saved + 2
    for a, b in zip(got, [dx] + grads):
        assert torch.equal(a, b)


def _loss_inputs(batch, length, device, seed):
    gen = torch.Generator().manual_seed(seed)
    s = torch.randn(batch, length, generator=gen)
    y = (torch.rand(batch, length, generator=gen) < 0.3).float()
    w = torch.rand(batch, length, generator=gen) + 0.5
    m = (torch.rand(batch, length, generator=gen) < 0.9).float()
    m[0] = 0.0            # a list with every position masked
    w[1] = 0.0            # a list whose denominator is 0
    y[2], m[2, length // 2:] = 0.0, 0.0
    return [t.to(device) for t in (s, y, w, m)]


@pytest.mark.parametrize("batch,length", [(256, 10), (1024, 200), (3, 1),
                                          (16384, 10), (64, 1300)])
def test_k3_k4_match_softmax_loss(cuda, batch, length):
    """One block ([256, 10], [3, 1]), many blocks ([1024, 200], [16384,
    10]) and lists read in chunks ([64, 1300]); K3's residual against its
    plain version, and K4 from it against autograd of softmax_loss."""
    s, y, w, m = _loss_inputs(batch, length, cuda, batch + length)
    sr = s.clone().requires_grad_(True)
    ref = losses.softmax_loss(sr, y, w, m)
    (ref_ds,) = torch.autograd.grad(2.5 * ref, sr)
    before = spans.counters()
    sk = s.clone().requires_grad_(True)
    got = listwise_loss.fused_softmax_loss(sk, y, w, m)
    (ds,) = torch.autograd.grad(2.5 * got, sk)
    _, stats = listwise_loss.listwise_loss_forward(s, y, w, m,
                                                   return_stats=True)
    ref_stats = listwise_loss.listwise_loss_stats_reference(s, y, w, m)
    torch.cuda.synchronize()
    after = spans.counters()
    assert (after["launches.K3"], after["launches.K4"]) == (
        before["launches.K3"] + 2, before["launches.K4"] + 1)
    torch.testing.assert_close(got, ref.detach(), rtol=1e-5, atol=1e-6)
    _close(ds, ref_ds, 1e-5)
    assert torch.equal(ds[0], torch.zeros_like(ds[0]))
    assert torch.equal(ds[1], torch.zeros_like(ds[1]))
    torch.testing.assert_close(stats.total, ref_stats.total, rtol=1e-5,
                               atol=1e-6)
    _close(stats.denom, ref_stats.denom, 1e-5)
    valid = m.sum(1) > 0   # a fully masked list's log_z is -1e9 + log(L)
    _close(stats.log_z[valid], ref_stats.log_z[valid], 1e-5)


def test_k3_all_lists_masked(cuda):
    s, y, w, _ = _loss_inputs(8, 10, cuda, 1)
    m = torch.zeros_like(s)
    loss, stats = listwise_loss.listwise_loss_forward(s, y, w, m,
                                                      return_stats=True)
    assert loss.item() == 0.0
    g = torch.ones((), device=cuda)
    assert torch.equal(
        listwise_loss.listwise_loss_backward(s, y, w, m, g, stats),
        torch.zeros_like(s))


@pytest.mark.parametrize("batch,length", [(16384, 10), (64, 1300)])
def test_k3_k4_rerun_gives_the_same_bits(cuda, batch, length):
    """Many blocks: the last block adds the partials in block order, so the
    loss does not depend on which block finishes last."""
    s, y, w, m = _loss_inputs(batch, length, cuda, 7)
    g = torch.tensor(1.5, device=cuda)
    runs = []
    for _ in range(3):
        loss, stats = listwise_loss.listwise_loss_forward(s, y, w, m,
                                                          return_stats=True)
        ds = listwise_loss.listwise_loss_backward(s, y, w, m, g, stats)
        runs.append([loss.clone(), stats.buffer.clone(), ds])
    torch.cuda.synchronize()
    for run in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(runs[0], run))


def test_k3_k4_take_strided_inputs_as_they_lie(cuda):
    """A stride-0 broadcast of one row (DLA's propensity logits) and column
    slices of wider rows (``train_slice``) give the bits of their
    contiguous copies, with no copy made (the launch reads their own
    storage)."""
    batch, length = 300, 10
    s, y, w, m = _loss_inputs(batch, 2 * length, cuda, 11)
    row = torch.randn(length, generator=torch.Generator().manual_seed(2))
    views = {"expanded scores": (row.to(cuda)[None, :].expand(batch, length),
                                 y[:, :length], w[:, :length],
                                 m[:, :length]),
             "sliced rows": (s[:, :length], y[:, :length], w[:, :length],
                             m[:, :length])}
    g = torch.tensor(0.7, device=cuda)
    for name, args in views.items():
        assert args[0].stride(1) == 1 and not args[1].is_contiguous()
        dense = [a.contiguous() for a in args]
        loss, stats = listwise_loss.listwise_loss_forward(*args,
                                                          return_stats=True)
        want, want_stats = listwise_loss.listwise_loss_forward(
            *dense, return_stats=True)
        ds = listwise_loss.listwise_loss_backward(*args, g, stats)
        want_ds = listwise_loss.listwise_loss_backward(*dense, g, want_stats)
        torch.cuda.synchronize()
        assert torch.equal(loss, want), name
        assert torch.equal(stats.buffer, want_stats.buffer), name
        assert torch.equal(ds, want_ds), name
    for args in views.values():
        alive, _ = listwise_loss._checked(*args)
        assert all(a is b for a, b in zip(alive, args))


def test_k4_from_the_plain_residual(cuda):
    """K4 alone: fed its plain version's residual, it matches the plain
    backward on the same residual."""
    s, y, w, m = _loss_inputs(1024, 200, cuda, 5)
    stats = listwise_loss.listwise_loss_stats_reference(s, y, w, m)
    g = torch.tensor(-1.25, device=cuda)
    ds = listwise_loss.listwise_loss_backward(s, y, w, m, g, stats)
    ref = listwise_loss.listwise_loss_backward_reference(s, y, w, m, g, stats)
    torch.cuda.synchronize()
    _close(ds, ref, 1e-5)


def test_k3_k4_raise_instead_of_falling_back(cuda):
    s, y, w, m = _loss_inputs(4, 10, cuda, 3)
    with pytest.raises(ValueError, match="float32"):
        listwise_loss.listwise_loss_forward(s.double(), y, w, m)
    with pytest.raises(ValueError, match="labels .* on cpu"):
        listwise_loss.listwise_loss_forward(s, y.cpu(), w, m)
    _, stats = listwise_loss.listwise_loss_forward(s, y, w, m,
                                                   return_stats=True)
    with pytest.raises(ValueError, match="cotangent"):
        listwise_loss.listwise_loss_backward(
            s, y, w, m, torch.ones(2, device=cuda), stats)


@pytest.mark.parametrize("shape", [(1,), (7, 10), (2304, 10), (50, 512, 10)])
def test_k5_equals_its_plain_version(cuda, shape):
    gen = torch.Generator(device=cuda).manual_seed(sum(shape))
    probs = torch.rand(shape, generator=gen, device=cuda)
    mask = (torch.rand(shape, generator=gen, device=cuda) < 0.9).float()
    key = click_sim.draw_key(gen)
    before = spans.counters()["launches.K5"]
    got = click_sim.pbm_clicks(probs, mask, key)
    ref = click_sim.pbm_clicks_reference(probs, mask, key)
    torch.cuda.synchronize()
    assert spans.counters()["launches.K5"] == before + 1
    assert torch.equal(got, ref)


def test_k5_position_rates(cuda):
    from ultra_pytorch_tpu_torch.sim.click_models import (
        click_probs, make_click_model)

    model = make_click_model("pbm", 0.1, 1.0, 4, 1.0).to(cuda)
    n = 200_000
    labels = torch.full((n, 10), 4.0, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(3)
    clicks = click_sim.sample_pbm_clicks(model, gen, labels)
    p = click_probs(model, labels[:1])[0]
    rate = clicks.mean(0)
    sigma = (p * (1 - p) / n).sqrt()
    assert bool(((rate - p).abs() <= 4 * sigma).all()), (rate, p)


# K1's wgmma instance (csrc/mlp_fwd_wg.cu): 8,448 rows are 132 full 64-row
# tiles, one a block on an H100; 8,449 and 30,721 end in a ragged tile of
# one row; 30,720 and 32,768 are the online lists and the 256x128 bucket.
WG_ROWS = [8448, 8449, 30720, 30721, 32768]


@pytest.mark.parametrize("features", [136, 220])
@pytest.mark.parametrize("n_rows", WG_ROWS)
def test_k1_wgmma_matches_plain_version(cuda, n_rows, features):
    """The wgmma instance, forced through the plan (8,448 and 8,449 rows
    take it only so), against the plain float32 version at the tolerance
    of K1's other card tests."""
    model, gen = _seeded_dnn(FULL, features, n_rows, cuda)
    x = torch.randn(n_rows, features, generator=gen).to(cuda)
    before = spans.counters()["launches.K1_wgmma"]
    with torch.inference_mode():
        got = mlp.mlp_forward(model.layers, x, "elu", True, _rows=mlp.WGMMA)
        ref = mlp.fused_mlp_score_reference(model.layers, x, "elu", True)
    torch.cuda.synchronize()
    assert spans.counters()["launches.K1_wgmma"] == before + 1
    torch.testing.assert_close(got, ref, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("use_norm", [True, False])
@pytest.mark.parametrize("activation", ["elu", "relu", "selu", "tanh",
                                        "sigmoid"])
def test_k1_wgmma_every_activation(cuda, activation, use_norm):
    """Each activation, with and without LayerNorm, at the online lists'
    30,720 rows, where the plan takes the wgmma instance itself."""
    model, gen = _seeded_dnn(FULL, 136, 7, cuda)
    x = torch.randn(256, 120, 136, generator=gen).to(cuda)
    before = spans.counters()["launches.K1_wgmma"]
    with torch.no_grad():
        got = mlp.fused_mlp_score(model.layers, x, activation, use_norm)
        ref = mlp.fused_mlp_score_reference(model.layers, x, activation,
                                            use_norm)
    torch.cuda.synchronize()
    assert spans.counters()["launches.K1_wgmma"] == before + 1
    torch.testing.assert_close(got, ref, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("hparams,features,activation,use_norm,n_rows", [
    (FULL, 136, "elu", True, 30720), (FULL, 220, "selu", True, 8449),
    (WITNESS[0], WITNESS[1], "sigmoid", False, 1000),
    (WITNESS[0], WITNESS[1], "sigmoid", False, 32768)])
def test_k1_wgmma_against_float64(cuda, hparams, features, activation,
                                  use_norm, n_rows):
    """Against float64, the witness of torch_mlp_probe.py: the wgmma
    instance's scores lie as close to it as the mma.sync instance's on the
    same inputs (both 3xTF32), on widths whose LayerNorm is well
    conditioned. (Over the witness's 5 sigmoid outputs a LayerNorm makes
    the distance to float64 a matter of each float32 order's rounding;
    there K1 is held to the plain version, as in
    test_k1_k2_ill_conditioned_layer_norm_against_float64.)"""
    model, gen = seeded_dnn(hparams, features, n_rows, cuda)
    x = torch.randn(n_rows, features, generator=gen).to(cuda)
    with torch.inference_mode():
        wg = mlp.mlp_forward(model.layers, x, activation, use_norm,
                             _rows=mlp.WGMMA)
        sync = mlp.mlp_forward(model.layers, x, activation, use_norm,
                               _rows=64)
        plain = mlp.fused_mlp_score_reference(model.layers, x, activation,
                                              use_norm)
    exact, _ = float64_grads(model.layers, x, torch.ones(n_rows, device=cuda),
                             activation, use_norm)
    torch.cuda.synchronize()
    offs = [off_float64([s], [exact]) for s in (wg, sync, plain)]
    print("wgmma, mma.sync, plain off float64:", offs)
    assert offs[0] <= 2 * max(offs[1], offs[2]), offs


@pytest.mark.parametrize("hparams,features,n_rows", [
    (FULL, 136, 30720), (FULL, 220, 8449), (WITNESS[0], WITNESS[1], 1000)])
def test_k1_wgmma_gives_the_mma_sync_bits(cuda, hparams, features, n_rows):
    """The two designs take every sum in the same order (the three
    products of each k8 step, LayerNorm's statistics a warp a row), so the
    wgmma instance's scores are the 64-row mma.sync instance's bits."""
    model, gen = seeded_dnn(hparams, features, n_rows, cuda)
    x = torch.randn(n_rows, features, generator=gen).to(cuda)
    with torch.inference_mode():
        wg = mlp.mlp_forward(model.layers, x, "elu", True, _rows=mlp.WGMMA)
        sync = mlp.mlp_forward(model.layers, x, "elu", True, _rows=64)
    torch.cuda.synchronize()
    assert torch.equal(wg, sync)


def test_k1_wgmma_bits_repeat_and_replay(cuda):
    """Two calls give the same bits, and a call captured in a CUDA graph
    and replayed gives the eager call's: tiles go to blocks at a static
    stride and every sum has a fixed order."""
    model, gen = _seeded_dnn(FULL, 136, 3, cuda)
    x = torch.randn(30720, 136, generator=gen).to(cuda)
    with torch.inference_mode():
        first = mlp.fused_mlp_score(model.layers, x)
        again = mlp.fused_mlp_score(model.layers, x)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            mlp.fused_mlp_score(model.layers, x)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            replayed = mlp.fused_mlp_score(model.layers, x)
        graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(first, again)
    assert torch.equal(first, replayed)


def test_k1_wgmma_is_chosen_for_scoring_alone(cuda):
    """``launches.K1_wgmma`` moves for a no-grad call on 64-row tiles, and
    not for a training step's 2,560 rows or a call that saves K2's
    residual."""
    model, gen = _seeded_dnn(FULL, 136, 4, cuda)
    lists = torch.randn(30720, 136, generator=gen).to(cuda)
    step = torch.randn(2560, 136, generator=gen).to(cuda)

    def counts():
        c = spans.snapshot()["counters"]
        return c["launches.K1"], c["launches.K1_wgmma"]

    k1, wg = counts()
    with torch.no_grad():
        mlp.fused_mlp_score(model.layers, lists)
    assert counts() == (k1 + 1, wg + 1)
    with torch.no_grad():
        mlp.fused_mlp_score(model.layers, step)
    assert counts() == (k1 + 2, wg + 1)
    mlp.fused_mlp_score(model.layers, lists.requires_grad_(True)).sum()
    assert counts() == (k1 + 3, wg + 1)


@pytest.mark.parametrize("widths", [
    (136, 512, 256, 128, 1), (220, 512, 256, 128, 1),
    (700, 512, 256, 128, 1), (37, 300, 70, 5, 1), (136, 1024, 1)])
def test_k1_wgmma_shared_memory_matches_the_kernel(cuda, widths):
    """The plan's count of the wgmma instance's shared memory is the
    kernel's own."""
    lib, _ = mlp._library()
    assert lib.ultra_mlp_fwd_wg_smem_bytes(
        mlp._c_ints(widths), len(widths) - 1) == mlp.wg_smem_bytes(widths)
