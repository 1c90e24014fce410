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
from ultra_pytorch_tpu_torch.utils import spans

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _inputs(seed=0, batch=8, length=10, all_masked=False):
    """s, y, w, m with list 0 fully masked, list 1's denominator 0 and list
    2 half masked (`batch` >= 3)."""
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
    before = spans.counters()
    _, ds = _torch_value_and_grad(losses.LOSS_FUNCTIONS["fused_softmax_loss"],
                                  s, y, w, m)
    assert not ds[0].any() and not ds[1].any()
    assert not ds[m == 0].any()
    assert spans.counters() == before


def test_fused_loss_takes_no_gradient_in_labels_weights_or_mask():
    s, y, w, m = (torch.from_numpy(a) for a in _inputs(4))
    ys, ws = y.clone().requires_grad_(True), w.clone().requires_grad_(True)
    loss = listwise_loss.fused_softmax_loss(s.requires_grad_(True), ys, ws, m)
    loss.backward()
    assert s.grad is not None and ys.grad is None and ws.grad is None


def test_backward_scales_with_the_incoming_cotangent():
    s, y, w, m = (torch.from_numpy(a) for a in _inputs(5))
    _, stats = listwise_loss.listwise_loss_forward(s, y, w, m,
                                                   return_stats=True)
    one = listwise_loss.listwise_loss_backward(s, y, w, m, torch.tensor(1.0),
                                               stats)
    half = listwise_loss.listwise_loss_backward(s, y, w, m, torch.tensor(0.5),
                                                stats)
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


def _close_to_largest(got, want, rtol=RTOL):
    """Within `rtol` of the largest magnitude of `want`."""
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= rtol * scale, (err, scale)


@pytest.mark.parametrize("batch,length", [(256, 10), (3, 1), (64, 300)])
def test_k3_k4_residual_reference_matches_jax(batch, length):
    """K3's residual and K4 from it, as plain tensor ops, against the JAX
    kernel's own prep (interpret mode) and its gradient, with a fully
    masked list and a zero-denominator list in the batch."""
    from ultra_pytorch_tpu.ops.pallas.listwise_loss import _prep

    s, y, w, m = _inputs(batch + length, batch, length)
    _, want_ds = _jax_value_and_grad(
        lambda ss, yy, ww, mm: 2.5 * jax_fused(ss, yy, ww, mm,
                                               interpret=True), s, y, w, m)
    wl, denom, _, log_softmax = (np.asarray(a) for a in _prep(
        *(jnp.asarray(a) for a in (s, y, w, m))))
    st, yt, wt, mt = (torch.from_numpy(a) for a in (s, y, w, m))
    stats = listwise_loss.listwise_loss_stats_reference(st, yt, wt, mt)
    np.testing.assert_allclose(stats.total.item(), wl.sum(), rtol=RTOL)
    _close_to_largest(stats.denom.numpy(), denom[:, 0])
    valid = m > 0   # where the masked score is a score, not -1e9
    got_log_softmax = s - stats.log_z.numpy()[:, None]
    if valid.any():   # [3, 1] may mask every position
        _close_to_largest(got_log_softmax[valid], log_softmax[valid])
    ds = listwise_loss.listwise_loss_backward_reference(
        st, yt, wt, mt, torch.tensor(2.5), stats)
    _close_to_largest(ds.numpy(), want_ds)
    assert not ds[0].any() and not ds[1].any()
    assert not ds[mt == 0].any()


def _emulated_k3(s, y, w, m):
    """K3's arithmetic in numpy, lane by lane and chunk by chunk as
    the kernel runs it (running max, rescaled sum-exp and rescaled sum of
    wl * (s~ - max)): the loss and per list (log_z, denom)."""
    batch, length = s.shape
    geo = listwise_loss.launch_geometry(batch, length)
    g, per, f32 = geo.lanes, listwise_loss.PER_LANE, np.float32
    wl_all = ((y + f32(1e-7)) * w * m).astype(f32)
    s_all = np.where(m > 0, s, f32(-1e9)).astype(f32)
    mx = np.full((batch, g), -1e9, f32)
    se, den, t = (np.zeros((batch, g), f32) for _ in range(3))
    for base in range(0, length, g * per):
        idx = base + np.arange(g)[:, None] + g * np.arange(per)[None, :]
        inside = idx < length                           # [g, per]
        sv = np.where(inside, s_all[:, np.minimum(idx, length - 1)], -1e9)
        wl = np.where(inside, wl_all[:, np.minimum(idx, length - 1)], 0.0)
        new = np.maximum(mx, sv.max(axis=2)).astype(f32)
        se = se * np.exp(mx - new) + np.where(
            inside, np.exp(sv - new[..., None]), 0.0).sum(axis=2)
        t = t - den * (new - mx) + (wl * (sv - new[..., None])).sum(axis=2)
        den = den + wl.sum(axis=2)
        mx = new
    gmx = mx.max(axis=1)
    lse = np.log((se * np.exp(mx - gmx[:, None])).sum(axis=1))
    t = (t - den * (gmx[:, None] - mx)).sum(axis=1)
    den = den.sum(axis=1)
    num = np.where(den > 0, den * lse - t, 0.0)
    total = den.sum()
    return num.sum() / (total if total > 0 else 1.0), gmx + lse, den


@pytest.mark.parametrize("batch,length", [(256, 10), (64, 300), (8, 1300)])
def test_chunked_list_arithmetic_matches_jax(batch, length):
    """The kernel's one-pass arithmetic, chunked lists included (L = 300
    and 1,300 read in 2 and 6 chunks of 256), against the JAX kernel."""
    s, y, w, m = _inputs(batch * length, batch, length)
    s = 3.0 * s + np.linspace(0.0, 5.0, length, dtype=np.float32)  # the
    # max moves from chunk to chunk
    want, _ = _jax_value_and_grad(
        lambda ss, yy, ww, mm: jax_fused(ss, yy, ww, mm, interpret=True),
        s, y, w, m)
    loss, log_z, den = _emulated_k3(s, y, w, m)
    np.testing.assert_allclose(loss, want, rtol=RTOL, atol=ATOL)
    stats = listwise_loss.listwise_loss_stats_reference(
        *(torch.from_numpy(a) for a in (s, y, w, m)))
    _close_to_largest(log_z, stats.log_z.numpy())
    _close_to_largest(den, stats.denom.numpy())


@pytest.mark.parametrize("length,lanes,chunks", [
    (1, 1, 1), (8, 1, 1), (9, 2, 1), (10, 2, 1), (32, 4, 1), (33, 8, 1),
    (200, 32, 1), (256, 32, 1), (257, 32, 2), (1300, 32, 6)])
@pytest.mark.parametrize("batch", [1, 3, 256, 1000, 16384])
@pytest.mark.parametrize("max_threads", [listwise_loss.K4_THREADS,
                                         listwise_loss.K3_THREADS])
def test_launch_geometry(batch, length, lanes, chunks, max_threads):
    geo = listwise_loss.launch_geometry(batch, length, max_threads)
    assert (geo.lanes, geo.chunks) == (lanes, chunks)
    per = listwise_loss.PER_LANE
    # a lane holds at most PER_LANE elements a chunk; chunks cover the list
    assert (chunks - 1) * lanes * per < length <= chunks * lanes * per
    if length <= 32 * per:
        assert -(-length // lanes) <= per
        assert lanes == 1 or -(-length // (lanes // 2)) > per  # the fewest
    # whole warps, one group never split across warps, no empty block
    assert geo.threads % 32 == 0 and 32 % geo.lanes == 0
    assert geo.threads <= max_threads <= listwise_loss.MAX_THREADS
    assert (geo.blocks - 1) * geo.threads < batch * lanes \
        <= geo.blocks * geo.threads
    if batch * lanes <= max_threads:
        assert geo.blocks == 1


def test_inputs_go_to_the_kernels_as_they_lie_when_rows_are_dense():
    """Row strides, not copies: a stride-0 broadcast of one row and column
    slices of wider rows are passed as they are, with their row strides; a
    transposed input (element stride > 1) is copied; a wrong dtype or shape
    raises."""
    rows = torch.arange(40, dtype=torch.float32).reshape(4, 10)
    wide = torch.zeros(4, 30)
    inputs = [rows[:1].expand(4, 10), wide[:, 5:15], rows, wide[:, :10]]
    alive, args = listwise_loss._checked(*inputs)
    assert all(a is b for a, b in zip(alive, inputs))
    assert args[:4] == [t.data_ptr() for t in inputs]
    assert args[4:] == [0, 30, 10, 30]
    flipped = torch.zeros(10, 4).t()
    alive, args = listwise_loss._checked(rows, flipped, rows, rows)
    assert alive[1] is not flipped and alive[1].is_contiguous()
    assert args[1] == alive[1].data_ptr() and args[5] == 10
    with pytest.raises(ValueError, match="labels must be float32"):
        listwise_loss._checked(rows, rows.double(), rows, rows)
    with pytest.raises(ValueError, match="mask must be float32"):
        listwise_loss._checked(rows, rows, rows, rows[:, :5])


def test_residual_layout_is_what_k4_reads():
    """LossStats holds (log_z, denom) a list, then total, in one buffer,
    as the kernels lay it out."""
    total, log_z, denom = torch.tensor(7.0), torch.arange(3.0), \
        10 + torch.arange(3.0)
    stats = listwise_loss.LossStats.of(total, log_z, denom)
    assert stats.buffer.tolist() == [0, 10, 1, 11, 2, 12, 7]
    assert stats.total.item() == 7.0
    assert torch.equal(stats.log_z, log_z) and torch.equal(stats.denom,
                                                           denom)


def test_training_shape_is_one_block_without_a_loop_over_lists():
    """K3 takes a training step's [256, 10] in one 512-thread block (no
    partials, no ticket); K4, which reduces nothing, in four of 128."""
    k3, k4 = listwise_loss.K3_THREADS, listwise_loss.K4_THREADS
    geometry = listwise_loss.launch_geometry
    assert geometry(256, 10, k3) == (2, 1, 512, 1)
    assert geometry(256, 10, k4) == (2, 1, 128, 4)
    assert geometry(16384, 10, k3) == (2, 1, 512, 64)
    assert geometry(64, 1300, k3) == (32, 6, 512, 4)
