"""The Linear, GSF, DLCM and SetRank rankers of the port against the JAX
package's, at small widths.

Each ranker takes the JAX ``init``'s weights (moved off their init by a
seeded perturbation, so every LayerNorm affine and bias matters) through
the generic bridge ``models.base.params_from_jax``. Then:

* ``jax_leaves()`` has the shapes and the order of
  ``jax.tree_util.tree_leaves`` of the JAX params, and the bridge carries
  every leaf both ways unchanged;
* scores agree within 1e-5, with and without a mask (the DLCM and SetRank
  masks pad lists out), at L = 10 and L = 14;
* the gradients of ``sum(scores * g)`` in every leaf agree within 1e-4 of
  their largest magnitude.

SetRank's dropout cannot match JAX's stream (threefry against torch's
generator), so it is held by its statistics: the keep rate and the
scaling within 4 sigma, the identity in eval, and a raise at ``rate > 0``
in training without a generator.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX package is the reference here

from ultra_pytorch_tpu.models.dlcm import DLCM as JaxDLCM  # noqa: E402
from ultra_pytorch_tpu.models.dnn import DNN as JaxDNN  # noqa: E402
from ultra_pytorch_tpu.models.gsf import GSF as JaxGSF  # noqa: E402
from ultra_pytorch_tpu.models.linear import Linear as JaxLinear  # noqa: E402
from ultra_pytorch_tpu.models.setrank import (  # noqa: E402
    SetRank as JaxSetRank)
from ultra_pytorch_tpu_torch.models import base  # noqa: E402
from ultra_pytorch_tpu_torch.models.dlcm import DLCM  # noqa: E402
from ultra_pytorch_tpu_torch.models.dnn import DNN  # noqa: E402
from ultra_pytorch_tpu_torch.models.gsf import GSF  # noqa: E402
from ultra_pytorch_tpu_torch.models.linear import Linear  # noqa: E402
from ultra_pytorch_tpu_torch.models.setrank import SetRank  # noqa: E402

F, B = 12, 8
SCORE_TOL = 1e-5
GRAD_TOL = 1e-4
RANKERS = {
    "Linear": (JaxLinear, Linear, ""),
    "GSF": (JaxGSF, GSF, "group_size=3,hidden_layer_sizes=[16, 8]"),
    "DLCM": (JaxDLCM, DLCM, "embed_size=8,hidden_size=6"),
    "SetRank": (JaxSetRank, SetRank,
                "d_model=16,num_heads=4,num_layers=2,diff=8"),
}
NAMES = pytest.mark.parametrize("name", list(RANKERS))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _perturbed(params, seed=1):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.2 * rng.normal(size=np.shape(a))
                   ).astype(np.float32), params)


def _pair(name, hparams=None, seed=0):
    """(JAX ranker, its perturbed params, the port's ranker loaded with
    them)."""
    jax_cls, cls, hp = RANKERS[name]
    hp = hp if hparams is None else hparams
    jax_ranker = jax_cls(hp, F)
    params = _perturbed(jax_ranker.init(jax.random.PRNGKey(seed), F))
    return jax_ranker, params, base.params_from_jax(cls(hp, F), params)


def _inputs(L, masked, seed=2):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, L, F)).astype(np.float32)
    mask = None
    if masked:
        mask = np.ones((B, L), np.float32)
        for b in range(B):
            mask[b, rng.integers(1, L + 1):] = 0.0
        mask[0, 1:] = 0.0   # a list of one document
        mask[1] = 1.0       # a full list
    return x, mask


def _t(a):
    return None if a is None else torch.from_numpy(a)


@NAMES
def test_jax_leaves_follow_the_jax_params_tree(name):
    _, params, model = _pair(name)
    want = jax.tree_util.tree_leaves(params)
    got = model.jax_leaves()
    assert [tuple(t.t().shape if tr else t.shape) for t, tr in got] == [
        tuple(np.shape(a)) for a in want]
    assert sum(t.numel() for t, _ in got) == sum(
        p.numel() for p in model.parameters())
    for (t, tr), a in zip(got, want):
        np.testing.assert_array_equal((t.t() if tr else t).detach().numpy(),
                                      np.asarray(a))
    back = jax.tree_util.tree_leaves(base.params_to_jax(model))
    for a, b in zip(back, want):
        np.testing.assert_array_equal(a, np.asarray(b))


@NAMES
@pytest.mark.parametrize("L", [10, 14])
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_scores_match_jax(name, L, masked):
    jax_ranker, params, model = _pair(name)
    x, mask = _inputs(L, masked)
    want = np.asarray(jax_ranker.apply(params, x, mask))
    with torch.no_grad():
        got = model(_t(x), _t(mask)).numpy()
    assert got.shape == (B, L)
    np.testing.assert_allclose(got, want, rtol=SCORE_TOL, atol=SCORE_TOL)


def _check_gradients(jax_ranker, params, model, x, mask):
    g = np.random.default_rng(5).normal(size=x.shape[:2]).astype(np.float32)
    want = jax.tree_util.tree_leaves(jax.grad(
        lambda p: (jax_ranker.apply(p, x, mask, is_training=True)
                   * g).sum())(params))
    leaves = model.jax_leaves()
    out = (model(_t(x), _t(mask), training=True) * _t(g)).sum()
    grads = torch.autograd.grad(out, [t for t, _ in leaves])
    largest = max(np.abs(np.asarray(w)).max() for w in want)
    for (_, tr), got, w in zip(leaves, grads, want):
        got = (got.t() if tr else got).numpy()
        np.testing.assert_allclose(got, np.asarray(w), rtol=0,
                                   atol=GRAD_TOL * largest)


@NAMES
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_gradients_match_jax(name, masked):
    jax_ranker, params, model = _pair(name)
    x, mask = _inputs(10, masked)
    _check_gradients(jax_ranker, params, model, x, mask)


@pytest.mark.parametrize("L", [1, 2])
def test_gsf_with_lists_shorter_than_its_groups(L):
    """L < m: an index repeats inside a group, and its scores add up (as
    JAX's ``.at[].add`` does)."""
    jax_ranker, params, model = _pair("GSF")
    x, _ = _inputs(L, False)
    want = np.asarray(jax_ranker.apply(params, x))
    with torch.no_grad():
        got = model(_t(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=SCORE_TOL, atol=SCORE_TOL)
    _check_gradients(jax_ranker, params, model, x, None)


def test_norm_none_matches_jax():
    """``norm=none`` skips the input LayerNorm, whose leaves stay in the
    tree; their gradient is 0 (JAX's zeros)."""
    for name, hp in (("Linear", "norm=none"),
                     ("GSF", "group_size=2,hidden_layer_sizes=[8],norm=none"),
                     ("DLCM", "embed_size=8,hidden_size=6,norm=none")):
        jax_ranker, params, model = _pair(name, hp)
        x, mask = _inputs(10, True)
        want = np.asarray(jax_ranker.apply(params, x, mask))
        with torch.no_grad():
            got = model(_t(x), _t(mask)).numpy()
        np.testing.assert_allclose(got, want, rtol=SCORE_TOL,
                                   atol=SCORE_TOL)


def test_dnn_leaf_order_is_unchanged():
    """The DNN's leaves keep their order (per layer: linear b, w, norm
    bias, scale), so its checkpoints keep their bits."""
    jax_dnn = JaxDNN("hidden_layer_sizes=[16, 8]", F)
    params = jax_dnn.init(jax.random.PRNGKey(0), F)
    model = base.params_from_jax(DNN("hidden_layer_sizes=[16, 8]", F),
                                 params)
    want = [l_ for layer in model.layers for l_ in (
        layer.linear.bias, layer.linear.weight, layer.norm.bias,
        layer.norm.weight)]
    assert all(a is b for (a, _), b in zip(model.jax_leaves(), want))
    assert [tr for _, tr in model.jax_leaves()] == [False, True, False,
                                                    False] * 3


def test_params_from_jax_rejects_another_structure():
    _, params, _ = _pair("SetRank")
    with pytest.raises(ValueError, match="layers"):
        base.params_from_jax(SetRank("d_model=16,num_heads=4,num_layers=1,"
                                     "diff=8", F), params)
    with pytest.raises(ValueError, match="shape"):
        base.params_from_jax(SetRank("d_model=16,num_heads=4,num_layers=2,"
                                     "diff=4", F), params)
    with pytest.raises(ValueError, match="keys"):
        base.params_from_jax(Linear("", F), params)


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_keep_rate_and_scaling(rate):
    n = 200_000
    x = torch.full((n,), 2.0)
    out = base.dropout(torch.Generator().manual_seed(0), x, rate, True)
    kept = out != 0
    p = 1.0 - rate
    assert abs(kept.float().mean().item() - p) <= 4 * np.sqrt(p * rate / n)
    assert torch.equal(out[kept], torch.full_like(out[kept], 2.0 / p))
    assert base.dropout(None, x, rate, False) is x
    assert base.dropout(None, x, 0.0, True) is x
    with pytest.raises(ValueError, match="generator"):
        base.dropout(None, x, rate, True)


def test_setrank_dropout_draws_and_modes():
    """At rate 0.1: eval is deterministic and draws nothing; training
    takes 1 + 2 * num_layers masks of torch.rand from the generator, in
    site order; without a generator it raises. At rate 0 training equals
    eval and draws nothing."""
    hp = "d_model=16,num_heads=4,num_layers=2,diff=8,rate=0.1"
    model = SetRank(hp, F, generator=torch.Generator().manual_seed(1))
    x, mask = (_t(a) for a in _inputs(10, True))
    gen = torch.Generator().manual_seed(3)
    before = gen.get_state()
    with torch.no_grad():
        eval_a = model(x, mask, generator=gen)
        eval_b = model(x, mask)
        assert torch.equal(gen.get_state(), before)
        assert torch.equal(eval_a, eval_b)
        train_a = model(x, mask, generator=gen, training=True)
        replay = torch.Generator().manual_seed(3)
        for _ in range(1 + 2 * 2):
            torch.rand((B, 10, 16), generator=replay)
        assert torch.equal(gen.get_state(), replay.get_state())
        train_b = model(x, mask, generator=gen, training=True)
    assert torch.isfinite(train_a).all()
    assert not torch.equal(train_a, eval_a)
    assert not torch.equal(train_a, train_b)
    with pytest.raises(ValueError, match="generator"):
        model(x, mask, training=True)

    plain = SetRank(hp.replace("rate=0.1", "rate=0.0"), F)
    gen = torch.Generator().manual_seed(3)
    before = gen.get_state()
    with torch.no_grad():
        assert torch.equal(plain(x, mask, generator=gen, training=True),
                           plain(x, mask))
    assert torch.equal(gen.get_state(), before)


@NAMES
def test_init_follows_the_generator(name):
    _, cls, hp = RANKERS[name]
    a = cls(hp, F, generator=torch.Generator().manual_seed(3))
    b = cls(hp, F, generator=torch.Generator().manual_seed(3))
    c = cls(hp, F, generator=torch.Generator().manual_seed(4))
    for pa, pb in zip(a.parameters(), b.parameters()):
        assert torch.equal(pa, pb)
    assert any(not torch.equal(pa, pc)
               for pa, pc in zip(a.parameters(), c.parameters()))
    for module in a.modules():
        if isinstance(module, torch.nn.Linear):
            bound = 1.0 / np.sqrt(module.in_features)
            assert module.weight.abs().max() <= bound
        if isinstance(module, base.LayerNorm):
            assert torch.equal(module.weight, torch.ones_like(module.weight))
