"""Team-draft multileaving in the port against the JAX package.

Given JAX's drafting order (``_round_assignments`` of each item's key),
the port's deterministic ``draft`` must equal JAX's vmapped ``_draft_one``
on the first L positions exactly (the draft over the whole list, which
JAX runs, agrees there because position m depends only on positions
below it), with R = 2 and 5 rankers and rankings with and without a
common prefix. ``infer_winners`` agrees within 1e-7. The port's own
drafting order is held statistically: the draft is a permutation and the
first pick falls to each ranker within 4 sigma of 1 / R.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX package is the reference here
pytest.importorskip("flax")  # its sim package needs it

from ultra_pytorch_tpu.sim import interleave as jax_il  # noqa: E402
from ultra_pytorch_tpu_torch.sim.interleave import (  # noqa: E402
    draft, infer_winners, round_assignments)

B, LC, L = 16, 12, 5


def _rankings(n_rankers, prefix, seed):
    """[B, R, LC] permutations; the first `prefix` positions shared."""
    rng = np.random.default_rng(seed)
    out = np.empty((B, n_rankers, LC), np.int32)
    for b in range(B):
        base = rng.permutation(LC)
        for r in range(n_rankers):
            tail = rng.permutation(base[prefix:])
            out[b, r] = np.concatenate([base[:prefix], tail])
    return out


def _jax_draft(rankings, seed):
    """JAX's assignments and its draft over the whole list."""
    keys = jax.random.split(jax.random.PRNGKey(seed), B)
    R = rankings.shape[1]
    assignments = np.array(jax.vmap(
        lambda k: jax_il._round_assignments(k, R, LC))(keys))
    docs, teams = jax.vmap(jax_il._draft_one)(rankings, assignments)
    return assignments, np.asarray(docs), np.asarray(teams)


@pytest.mark.parametrize("n_rankers", [2, 5])
@pytest.mark.parametrize("prefix", [0, 3], ids=["no_prefix", "prefix"])
def test_draft_equals_jax_given_its_assignments(n_rankers, prefix):
    rankings = _rankings(n_rankers, prefix, seed=10 * n_rankers + prefix)
    assignments, docs, teams = _jax_draft(rankings, seed=n_rankers)
    got_docs, got_teams = draft(torch.from_numpy(rankings),
                                torch.from_numpy(assignments), L)
    np.testing.assert_array_equal(got_docs.numpy(), docs[:, :L])
    np.testing.assert_array_equal(got_teams.numpy(), teams[:, :L])
    if prefix:
        assert (got_teams[:, :prefix] == -1).all()
    # The whole list: the same draft, a permutation of the slots.
    full_docs, full_teams = draft(torch.from_numpy(rankings),
                                  torch.from_numpy(assignments), LC)
    np.testing.assert_array_equal(full_docs.numpy(), docs)
    np.testing.assert_array_equal(full_teams.numpy(), teams)


@pytest.mark.parametrize("n_rankers", [2, 5])
def test_infer_winners_equals_jax(n_rankers):
    rng = np.random.default_rng(n_rankers)
    teams = rng.integers(-1, n_rankers, size=(B, L)).astype(np.int32)
    clicks = (rng.random((B, L)) < 0.4).astype(np.float32)
    want = np.asarray(jax_il.infer_winners(teams, clicks, n_rankers))
    got = infer_winners(torch.from_numpy(teams).long(),
                        torch.from_numpy(clicks), n_rankers)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-7)


def test_round_assignments_are_permutation_rounds():
    gen = torch.Generator().manual_seed(0)
    got = round_assignments(gen, 64, 3, 10)
    assert got.shape == (64, 10)
    for row in got.numpy():
        for start in range(0, 9, 3):
            assert sorted(row[start:start + 3]) == [0, 1, 2]


@pytest.mark.parametrize("n_rankers", [2, 5])
def test_draft_is_a_permutation_and_the_first_pick_is_fair(n_rankers):
    """4,000 items whose rankers all lead with another document: the
    full draft is a permutation, and each ranker picks first within 4
    sigma of 1 / R."""
    n, lc = 4000, 8
    gen = torch.Generator().manual_seed(n_rankers)
    rest = torch.rand((n, n_rankers, lc), generator=gen).argsort(dim=-1)
    # Ranker r's list starts with document r, then the others in a random
    # order.
    lead = torch.arange(n_rankers).view(1, -1, 1).expand(n, -1, 1)
    others = rest[(rest != lead).expand_as(rest)].view(n, n_rankers, lc - 1)
    rankings = torch.cat([lead, others], dim=-1)
    docs, teams = draft(rankings, round_assignments(gen, n, n_rankers, lc),
                        lc)
    assert (docs.sort(dim=1).values == torch.arange(lc)).all()
    assert (teams >= 0).all()
    share = torch.bincount(teams[:, 0], minlength=n_rankers).double() / n
    p = 1.0 / n_rankers
    sigma = (p * (1 - p) / n) ** 0.5
    assert (share - p).abs().max().item() < 4 * sigma, share
