"""The port's losses and K3/K4's plain version against the JAX package.

Inputs are made with numpy from a seed and go to both packages. Every
batch holds masked positions, a list whose weights are all zero (its
denominator is 0) and a list with every position masked. float32 sums in
another order: 1e-5 relative, 1e-6 absolute.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX package is the reference here
import jax.numpy as jnp  # noqa: E402

from ultra_pytorch_tpu.ops import losses as jax_losses
from ultra_pytorch_tpu.ops.pallas.listwise_loss import (
    fused_softmax_loss as jax_fused)
from ultra_pytorch_tpu_torch.ops import losses
from ultra_pytorch_tpu_torch.ops.kernels import listwise_loss

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _inputs(seed=0, batch=8, length=10, all_masked=False):
    rng = np.random.default_rng(seed)
    s = rng.normal(size=(batch, length)).astype(np.float32)
    y = (rng.random((batch, length)) < 0.3).astype(np.float32)
    w = (rng.random((batch, length)) + 0.5).astype(np.float32)
    m = (rng.random((batch, length)) < 0.85).astype(np.float32)
    m[0] = 0.0                         # every position masked
    w[1] = 0.0                         # denominator 0
    y[2, 0], m[2, length // 2:] = 1.0, 0.0
    if all_masked:
        m[:] = 0.0
    return s, y, w, m


def _jax_value_and_grad(fn, s, y, w, m):
    value, ds = jax.value_and_grad(
        lambda ss: fn(ss, jnp.asarray(y), jnp.asarray(w), jnp.asarray(m)))(
            jnp.asarray(s))
    return float(value), np.asarray(ds)


def _torch_value_and_grad(fn, s, y, w, m):
    st = torch.from_numpy(s).requires_grad_(True)
    value = fn(st, *(torch.from_numpy(a) for a in (y, w, m)))
    (ds,) = torch.autograd.grad(value, st)
    return value.item(), ds.numpy()


@pytest.mark.parametrize("all_masked", [False, True],
                         ids=["mixed", "all-masked"])
@pytest.mark.parametrize("name", ["softmax_loss", "sigmoid_loss",
                                  "pairwise_loss", "fused_softmax_loss"])
def test_loss_and_gradient_match_jax(name, all_masked):
    s, y, w, m = _inputs(1, all_masked=all_masked)
    jax_fn = jax_losses.LOSS_FUNCTIONS[name]
    if name == "fused_softmax_loss":
        def jax_fn(ss, yy, ww, mm):
            return jax_fused(ss, yy, ww, mm, interpret=True)
    want, want_ds = _jax_value_and_grad(jax_fn, s, y, w, m)
    got, ds = _torch_value_and_grad(losses.LOSS_FUNCTIONS[name], s, y, w, m)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ds, want_ds, rtol=RTOL, atol=ATOL)
    if all_masked and "softmax" in name:
        assert got == 0.0 and not ds.any()


def test_softmax_loss_without_weights_or_mask_matches_jax():
    s, y, _, _ = _inputs(2)
    want = jax_losses.softmax_loss(jnp.asarray(s), jnp.asarray(y))
    got = losses.softmax_loss(torch.from_numpy(s), torch.from_numpy(y))
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL, atol=ATOL)
    fused = listwise_loss.fused_softmax_loss(torch.from_numpy(s),
                                             torch.from_numpy(y))
    np.testing.assert_allclose(fused.item(), float(want), rtol=RTOL,
                               atol=ATOL)


def test_fused_plain_version_edge_cases():
    """A zero-denominator list and a fully masked list take no gradient;
    masked positions take none; the CPU path launches nothing."""
    s, y, w, m = _inputs(3)
    before = (listwise_loss.listwise_loss_forward.launches,
              listwise_loss.listwise_loss_backward.launches)
    _, ds = _torch_value_and_grad(losses.LOSS_FUNCTIONS["fused_softmax_loss"],
                                  s, y, w, m)
    assert not ds[0].any() and not ds[1].any()
    assert not ds[m == 0].any()
    assert (listwise_loss.listwise_loss_forward.launches,
            listwise_loss.listwise_loss_backward.launches) == before


def test_fused_loss_takes_no_gradient_in_labels_weights_or_mask():
    s, y, w, m = (torch.from_numpy(a) for a in _inputs(4))
    ys, ws = y.clone().requires_grad_(True), w.clone().requires_grad_(True)
    loss = listwise_loss.fused_softmax_loss(s.requires_grad_(True), ys, ws, m)
    loss.backward()
    assert s.grad is not None and ys.grad is None and ws.grad is None


def test_backward_scales_with_the_incoming_cotangent():
    s, y, w, m = (torch.from_numpy(a) for a in _inputs(5))
    one = listwise_loss.listwise_loss_backward(s, y, w, m, torch.tensor(1.0))
    half = listwise_loss.listwise_loss_backward(s, y, w, m, torch.tensor(0.5))
    torch.testing.assert_close(half, 0.5 * one)


def test_pairwise_cross_entropy_and_l2_match_jax():
    rng = np.random.default_rng(6)
    pos, neg, pw = (rng.normal(size=(7, 1)).astype(np.float32)
                    for _ in range(3))
    want = jax_losses.pairwise_cross_entropy_loss(
        jnp.asarray(pos), jnp.asarray(neg), jnp.asarray(pw))
    got = losses.pairwise_cross_entropy_loss(
        torch.from_numpy(pos), torch.from_numpy(neg), torch.from_numpy(pw))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    tensors = [rng.normal(size=shape).astype(np.float32)
               for shape in ((3, 4), (5,), ())]
    want = jax_losses.l2_loss({"a": tensors[0], "b": [tensors[1],
                                                       tensors[2]]})
    got = losses.l2_loss([torch.from_numpy(t) for t in tensors])
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL, atol=ATOL)


def test_loss_table_keeps_the_jax_keys():
    assert set(losses.LOSS_FUNCTIONS) == set(jax_losses.LOSS_FUNCTIONS)
