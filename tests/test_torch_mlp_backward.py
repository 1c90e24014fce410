"""K2, the fused MLP backward: the plain version against the JAX kernel.

On the CPU ``mlp_backward`` runs K2's plain version (autograd through the
plain forward). It is held to the vjp of the JAX ``fused_mlp_score``
custom_vjp, whose backward is the Pallas ``_bwd_kernel`` run in interpret
mode: 600 rows are three of its 256-row tiles, so its cross-tile
accumulation of the parameter gradients is exercised. Sums over rows are
taken in another order, hence 2e-4 (tests/test_pallas_kernels.py's
tolerance for the same comparison).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX package is the reference here

from ultra_pytorch_tpu.models.base import ACTIVATIONS
from ultra_pytorch_tpu.models.dnn import DNN as JaxDNN
from ultra_pytorch_tpu.ops.pallas.mlp import fused_mlp_score as jax_fused
from ultra_pytorch_tpu_torch.models.dnn import DNN, params_from_jax
from ultra_pytorch_tpu_torch.ops.kernels import mlp
from ultra_pytorch_tpu_torch.utils import spans

F = 24
HIDDEN = "hidden_layer_sizes=[16, 8]"
TOL = 2e-4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pair():
    params = JaxDNN(HIDDEN, F).init(jax.random.PRNGKey(0), F)
    params = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.default_rng(0)
    for layer in params["layers"]:
        n = layer["norm"]["scale"].shape[0]
        layer["norm"]["scale"] = (1 + 0.2 * rng.normal(size=n)).astype(
            np.float32)
        layer["norm"]["bias"] = (0.2 * rng.normal(size=n)).astype(np.float32)
    return params, params_from_jax(DNN(HIDDEN, F), params)


def _jax_vjp(params, x, g, activation, use_norm):
    def score(p, xx):
        return jax_fused(p["layers"], xx, activation=ACTIVATIONS[activation],
                         use_norm=use_norm, interpret=True)

    _, vjp = jax.vjp(score, params, x)
    dparams, dx = vjp(g)
    return np.asarray(dx), dparams


@pytest.mark.parametrize("use_norm", [True, False], ids=["norm", "no-norm"])
@pytest.mark.parametrize("activation", ["elu", "relu", "tanh", "selu"])
def test_plain_backward_matches_jax_kernel(pair, activation, use_norm):
    params, model = pair
    rng = np.random.default_rng(7)
    x = rng.normal(size=(600, F)).astype(np.float32)
    g = rng.normal(size=600).astype(np.float32)
    want_dx, want = _jax_vjp(params, x, g, activation, use_norm)
    dx, grads = mlp.mlp_backward(model.layers, torch.from_numpy(x),
                                 torch.from_numpy(g), activation, use_norm)
    np.testing.assert_allclose(dx.numpy(), want_dx, rtol=TOL, atol=TOL)
    for j, layer in enumerate(want["layers"]):
        dscale, dbias, dw, db = (t.numpy() for t in grads[4 * j: 4 * j + 4])
        np.testing.assert_allclose(dw.T, layer["linear"]["w"], rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(db, layer["linear"]["b"], rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(dscale, layer["norm"]["scale"], rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(dbias, layer["norm"]["bias"], rtol=TOL,
                                   atol=TOL)


def test_autograd_through_fused_score_matches_jax_grad(pair):
    """``fused_mlp_score`` is differentiable on the CPU (FusedMLP with the
    plain versions) and gives JAX's gradients of a loss over [B, L]."""
    params, model = pair
    rng = np.random.default_rng(3)
    x = rng.normal(size=(4, 5, F)).astype(np.float32)
    target = rng.normal(size=(4, 5)).astype(np.float32)

    def loss(p):
        s = jax_fused(p["layers"], x, interpret=True)
        return ((s - target) ** 2).sum()

    want = jax.grad(loss)(params)
    model.zero_grad()
    before = spans.counters()
    s = mlp.fused_mlp_score(model.layers, torch.from_numpy(x))
    ((s - torch.from_numpy(target)) ** 2).sum().backward()
    assert spans.counters() == before
    for mine, theirs in zip(model.layers, want["layers"]):
        np.testing.assert_allclose(mine.linear.weight.grad.numpy().T,
                                   theirs["linear"]["w"], rtol=TOL, atol=TOL)
        np.testing.assert_allclose(mine.norm.weight.grad.numpy(),
                                   theirs["norm"]["scale"], rtol=TOL,
                                   atol=TOL)


def test_empty_batch_has_zero_gradients(pair):
    _, model = pair
    dx, grads = mlp.mlp_backward(model.layers, torch.zeros(0, F),
                                 torch.zeros(0), "elu", True)
    assert dx.shape == (0, F)
    assert all(not g.any() for g in grads)
