"""The port's ranking metrics against the JAX package's ``evaluate``.

Scores are drawn from a continuous distribution, so they have no ties
and both packages sort them the same way; labels include invalid (-1)
entries and the mask pads list tails. float32 means over the batch:
1e-5 relative, 1e-6 absolute.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX package is the reference here
import jax.numpy as jnp  # noqa: E402

from ultra_pytorch_tpu.metrics import ranking as jax_metrics
from ultra_pytorch_tpu_torch.metrics import ranking as metrics

ALL = ["mrr", "err", "arp", "ndcg", "dcg", "precision", "map",
       "ordered_pair_accuracy"]
TOPN = [1, 3, 5, 10]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _batch(seed, batch=16, length=10):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 5, size=(batch, length)).astype(np.float32)
    labels[rng.random((batch, length)) < 0.05] = -1.0
    scores = rng.normal(size=(batch, length)).astype(np.float32)
    mask = np.ones((batch, length), np.float32)
    for b in range(batch):
        mask[b, rng.integers(2, length + 1):] = 0.0
    weights = (rng.random((batch, length)) + 0.5).astype(np.float32)
    return labels, scores, mask, weights


@pytest.mark.parametrize("with_weights", [False, True],
                         ids=["unweighted", "weighted"])
@pytest.mark.parametrize("with_mask", [False, True], ids=["full", "masked"])
def test_every_metric_matches_jax(with_mask, with_weights):
    labels, scores, mask, weights = _batch(0)
    kwargs = dict(max_label=4.0)
    want = jax_metrics.evaluate(
        jnp.asarray(labels), jnp.asarray(scores), ALL, TOPN,
        mask=jnp.asarray(mask) if with_mask else None,
        weights=jnp.asarray(weights) if with_weights else None, **kwargs)
    got = metrics.evaluate(
        torch.from_numpy(labels), torch.from_numpy(scores), ALL, TOPN,
        mask=torch.from_numpy(mask) if with_mask else None,
        weights=torch.from_numpy(weights) if with_weights else None,
        **kwargs)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_mask_padding_matches_jax():
    _, scores, mask, _ = _batch(1)
    np.testing.assert_array_equal(
        metrics.mask_padding(torch.from_numpy(scores),
                             torch.from_numpy(mask)).numpy(),
        np.asarray(jax_metrics.mask_padding(jnp.asarray(scores),
                                            jnp.asarray(mask))))


def test_random_tie_break_keeps_strict_order_and_shuffles_ties():
    gen = torch.Generator().manual_seed(0)
    strict = torch.randn(64, 10, generator=gen)
    broken = metrics.random_tie_break(gen, strict)
    assert torch.equal(torch.argsort(broken, dim=1),
                       torch.argsort(strict, dim=1))
    tied = torch.tensor([[1.0, 1.0, 0.0, 1.0]]).repeat(4000, 1)
    firsts = torch.argsort(-metrics.random_tie_break(gen, tied), dim=1)[:, 0]
    counts = torch.bincount(firsts, minlength=4).float() / 4000
    assert counts[2] == 0.0
    assert ((counts[[0, 1, 3]] - 1 / 3).abs() < 0.04).all()
    # Ties must not reorder against a strictly smaller score.
    assert bool((metrics.random_tie_break(gen, tied)[:, 2] < 1.0).all())


def test_evaluate_with_generator_on_tie_free_scores_matches_jax():
    labels, scores, mask, _ = _batch(2)
    want = jax_metrics.evaluate(jnp.asarray(labels), jnp.asarray(scores),
                                ["ndcg", "mrr"], TOPN, max_label=4.0,
                                mask=jnp.asarray(mask))
    got = metrics.evaluate(torch.from_numpy(labels), torch.from_numpy(scores),
                           ["ndcg", "mrr"], TOPN, max_label=4.0,
                           mask=torch.from_numpy(mask),
                           generator=torch.Generator().manual_seed(1))
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_err_needs_max_label_and_unknown_keys_raise():
    with pytest.raises(ValueError, match="max_label"):
        metrics.make_ranking_metric_fn("err", [5])
    with pytest.raises(ValueError, match="not supported"):
        metrics.make_ranking_metric_fn("bleu", [5])
