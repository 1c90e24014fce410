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
    before = mlp.fused_mlp_score.launches
    with torch.no_grad():
        mlp.fused_mlp_score(model.layers, torch.zeros(4, F))
    assert mlp.fused_mlp_score.launches == before


def test_packed_params_follow_parameter_updates():
    model = DNN(HIDDEN, F, generator=torch.Generator().manual_seed(0))
    first = mlp._packed(model.layers)
    assert mlp._packed(model.layers) is first  # cached
    # Layer 0 takes [scale 24, bias 24, W 24x32, b 32]; layer 1's W
    # follows its own scale and bias, in JAX's [in, out] layout.
    w1 = 2 * F + F * 32 + 32 + 2 * 32
    np.testing.assert_array_equal(
        first[w1: w1 + 32 * 16].reshape(32, 16).numpy(),
        model.layers[1].linear.weight.detach().t().numpy())
    assert first.numel() == sum(p.numel() for p in model.parameters())
    with torch.no_grad():
        model.layers[0].linear.weight.mul_(2.0)
    again = mlp._packed(model.layers)
    assert again is not first
    assert not torch.equal(again, first)


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
@pytest.mark.parametrize("n_rows", [1, 31, 1000, 4096])
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
    before = mlp.fused_mlp_score.launches
    with torch.inference_mode():
        got = mlp.fused_mlp_score(model.layers, x, activation, use_norm)
        ref = mlp.fused_mlp_score_reference(model.layers, x, activation,
                                            use_norm)
    torch.cuda.synchronize()
    assert mlp.fused_mlp_score.launches == before + 1
    # Sums over K <= 512 taken in another order than cuBLAS's.
    torch.testing.assert_close(got, ref, rtol=2e-4, atol=2e-4)
    # With gradients on, the same call trains through K2; its gradients
    # are held to autograd of the plain version (sums over rows in
    # another order, so relative to the largest gradient).
    g = torch.randn(n_rows, generator=gen).cuda() * kink_free_rows(
        model, x, activation, use_norm)
    k2 = mlp.mlp_backward.launches
    xg = x.clone().requires_grad_(True)
    mlp.fused_mlp_score(model.layers, xg, activation, use_norm).backward(g)
    assert mlp.mlp_backward.launches == k2 + 1
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
