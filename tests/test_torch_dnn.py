"""The port's DNN ranker against the JAX DNN on the same weights.

A JAX ``DNN.init`` goes through ``params_from_jax`` into the port's
module, and the same features (numpy, from a seed) go through both.
"""

import itertools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX package is the reference here

from ultra_pytorch_tpu.models.dnn import DNN as JaxDNN
from ultra_pytorch_tpu_torch.models import base
from ultra_pytorch_tpu_torch.models.dnn import (
    DNN, params_from_jax, params_to_jax)

F = 24
HIDDEN = "hidden_layer_sizes=[32, 16]"
# f32: the tolerance of tests/test_pallas_kernels.py:28.
F32_TOL = 2e-5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _pair(hparams, seed=0):
    """(jax ranker, jax params, port model holding the same weights)."""
    jax_dnn = JaxDNN(hparams, F)
    params = jax_dnn.init(jax.random.PRNGKey(seed), F)
    # A non-trivial LayerNorm affine, as after training.
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(np.asarray, params)
    for layer in params["layers"]:
        n = layer["norm"]["scale"].shape[0]
        layer["norm"]["scale"] = (1 + 0.2 * rng.normal(size=n)).astype(
            np.float32)
        layer["norm"]["bias"] = (0.2 * rng.normal(size=n)).astype(np.float32)
    return jax_dnn, params, params_from_jax(DNN(hparams, F), params)


def _features(shape=(6, 9, F), seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("activation,norm,fold", list(itertools.product(
    ["elu", "relu", "selu", "tanh", "sigmoid"], ["layer", "none"],
    [True, False])))
def test_forward_matches_jax(activation, norm, fold):
    hp = (f"{HIDDEN},activation_func={activation},norm={norm},"
          f"fold_norm_affine={fold}")
    jax_dnn, params, model = _pair(hp)
    x = _features()
    want = np.asarray(jax_dnn.apply(params, x))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (6, 9)
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("fold", [True, False])
def test_bfloat16_forward_matches_jax(fold):
    # bf16 keeps 8 bits of mantissa (rel. step 2^-8 ~ 4e-3), and the two
    # frameworks round bf16 at different places (where the product is
    # accumulated and where the bias is added), so the scores agree to a
    # few bf16 steps of the activations, not to float32 rounding.
    hp = f"{HIDDEN},compute_dtype=bfloat16,fold_norm_affine={fold}"
    jax_dnn, params, model = _pair(hp)
    x = _features()
    want = np.asarray(jax_dnn.apply(params, x))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=3e-2, atol=3e-2)


def test_use_pallas_on_cpu_matches_plain_path():
    jax_dnn, params, model = _pair(HIDDEN + ",use_pallas=true")
    x = _features()
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    want = np.asarray(JaxDNN(HIDDEN, F).apply(params, x))
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)


def test_params_round_trip_in_jax_leaf_order():
    _, params, model = _pair(HIDDEN)
    back = params_to_jax(model)
    want = jax.tree_util.tree_leaves(params)
    from ultra_pytorch_tpu_torch.utils.checkpoint import tree_leaves
    got = tree_leaves(back)
    assert len(got) == len(want) == 4 * 3
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_params_from_jax_rejects_wrong_shapes():
    _, params, _ = _pair(HIDDEN)
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(DNN("hidden_layer_sizes=[32, 8]", F), params)
    with pytest.raises(ValueError, match="layers"):
        params_from_jax(DNN("hidden_layer_sizes=[32]", F), params)


def test_init_is_torch_default_on_a_generator():
    a = DNN(HIDDEN, F, generator=torch.Generator().manual_seed(3))
    b = DNN(HIDDEN, F, generator=torch.Generator().manual_seed(3))
    c = DNN(HIDDEN, F, generator=torch.Generator().manual_seed(4))
    for pa, pb in zip(a.parameters(), b.parameters()):
        assert torch.equal(pa, pb)
    assert not torch.equal(a.layers[0].linear.weight,
                           c.layers[0].linear.weight)
    for layer in a.layers:
        bound = 1.0 / np.sqrt(layer.linear.in_features)
        assert layer.linear.weight.abs().max() <= bound
        assert layer.linear.bias.abs().max() <= bound
        assert torch.equal(layer.norm.weight,
                           torch.ones_like(layer.norm.weight))
        assert torch.equal(layer.norm.bias, torch.zeros_like(layer.norm.bias))
    assert [layer.linear.out_features for layer in a.layers] == [32, 16, 1]


def test_normalize_uses_clamped_one_pass_variance():
    # A constant row has E[x^2] - E[x]^2 slightly negative in float32; the
    # clamp keeps rsqrt finite, as the JAX package's normalize_f32 does.
    x = torch.full((2, 7), 3.1, dtype=torch.float32)
    out = base.normalize_f32(x)
    assert torch.isfinite(out).all()
    from ultra_pytorch_tpu.models.base import normalize_f32 as jax_norm
    y = _features((5, 11))
    np.testing.assert_allclose(base.normalize_f32(torch.from_numpy(y)),
                               np.asarray(jax_norm(y)), rtol=1e-6, atol=1e-6)
