"""The port's online simulation feeds against the JAX package's.

Given the JAX feed's ranking and its uniforms (reproduced from its key
splits: queries, ranking and clicks from one split of three, the 16
resample rounds from ``fold_in(kc, 7)``), the port's deterministic core
``online_batch`` must give the same batch exactly: reranked features,
clicks on the top L with labels beyond it zeroed, the mask of lists that
never clicked, initial scores and ``relevance``. The deterministic feed's
ranking equals JAX's ``deterministic_rank``; the stochastic feed's first
pick follows ``softmax(tau * s)`` within 4 sigma. The dynamic-bias
schedule is the JAX test's, on the port.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX package is the reference here
pytest.importorskip("flax")  # its algorithms need it

from ultra_pytorch_tpu.data.dataset import RankingDataset as JaxDataset
from ultra_pytorch_tpu.input_layer import feeds as jax_feeds
from ultra_pytorch_tpu.run.experiment import (
    create_algorithm as jax_create_algorithm)
from ultra_pytorch_tpu.sim.click_models import main as jax_cm_main
from ultra_pytorch_tpu_torch.data.dataset import RankingDataset
from ultra_pytorch_tpu_torch.input_layer import feeds
from ultra_pytorch_tpu_torch.run.experiment import create_algorithm

Q, LC, F = 300, 12, 6
CUT, B = 5, 16
FEEDS = ("DeterministicOnlineSimulationFeed",
         "StochasticOnlineSimulationFeed")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def click_json(tmp_path_factory):
    out = tmp_path_factory.mktemp("pbm")
    jax_cm_main(["pbm", "0.1", "1.0", "4", "1.0", str(out)])
    return str(out / "pbm_0.1_1.0_4_1.0.json")


def _arrays(seed=0):
    """Q lists of 2-12 documents with grades 0-4."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(2, LC + 1, size=Q)
    d = int(lengths.sum())
    initial_list = -np.ones((Q, LC), np.int64)
    labels = np.zeros((Q, LC), np.float32)
    start = 0
    for q, n in enumerate(lengths):
        initial_list[q, :n] = np.arange(start, start + n)
        labels[q, :n] = rng.integers(0, 5, size=n)
        start += n
    return dict(features=rng.normal(size=(d, F)).astype(np.float32),
                initial_list=initial_list, labels=labels,
                qids=[str(q) for q in range(Q)],
                dids=[f"d{i}" for i in range(d)], feature_size=F,
                rank_list_size=LC, max_label=4.0)


def _settings():
    return {"ranking_model": "Linear", "ranking_model_hparams": "",
            "learning_algorithm": "NaiveAlgorithm",
            "learning_algorithm_hparams": "",
            "max_candidate_num": LC, "selection_bias_cutoff": CUT,
            "metrics": ["ndcg"], "metrics_topn": [5]}


def _pair(cls, hparams):
    """(JAX feed, JAX state, port feed, port state) on the same data; the
    port's ranker carries JAX's weights."""
    arrs = _arrays()
    jax_alg = jax_create_algorithm(_settings(), F, 4.0)
    jax_state = jax_alg.init_state(jax.random.PRNGKey(0), F)
    jax_feed = getattr(jax_feeds, cls)(jax_alg, B, hparams,
                                       JaxDataset(**arrs).to_device())
    alg = create_algorithm(_settings(), F, 4.0, device="cpu")
    state = alg.load_state_leaves(
        alg.init_state(torch.Generator().manual_seed(0)),
        [np.asarray(x) for x in jax.tree_util.tree_leaves(jax_state)])
    feed = getattr(feeds, cls)(alg, B, hparams,
                               RankingDataset(**arrs).to_device("cpu"))
    return jax_feed, jax_state, feed, state


def _jax_draws(jax_feed, jax_state, rng):
    """The JAX feed's queries, ranking and the uniforms of its first
    click draw and 16 resample rounds, from its key splits."""
    kq, kr, kc = jax.random.split(rng, 3)
    qs = jax.random.randint(kq, (B,), 0, Q)
    batch = jax_feed.dataset.gather(qs)
    scores = jax_feed.algorithm.score(jax_state, batch)
    ranking = jax_feed._rank(kr, scores, batch["mask"])
    keys = jax.random.split(jax.random.fold_in(kc, 7),
                            jax_feed.CLICK_RESAMPLE_ROUNDS)
    u = [jax.random.uniform(kc, (B, CUT))] + [
        jax.random.uniform(k, (B, CUT)) for k in keys]
    return (np.array(qs), np.array(scores), np.array(ranking),
            np.stack([np.asarray(x) for x in u]))


@pytest.mark.parametrize("cls", FEEDS)
@pytest.mark.parametrize("hparams", ["", "oracle_mode=true"],
                         ids=["clicks", "oracle"])
def test_online_batch_equals_jax_given_its_draws(click_json, cls, hparams):
    hparams = f"click_model_json={click_json},{hparams}".rstrip(",")
    jax_feed, jax_state, feed, state = _pair(cls, hparams)
    for seed in range(3):
        rng = jax.random.PRNGKey(seed)
        want = jax_feed.train_batch(rng, jax_state)
        qs, _, ranking, u = _jax_draws(jax_feed, jax_state, rng)
        batch = feed.dataset.gather(torch.from_numpy(qs))
        got = feed.online_batch(
            batch, torch.from_numpy(ranking).long(),
            None if feed.hparams.oracle_mode else torch.from_numpy(u),
            state.step)
        assert sorted(got) == sorted(want)
        for key in want:
            np.testing.assert_array_equal(got[key].numpy(),
                                          np.asarray(want[key]), err_msg=key)
        if not feed.hparams.oracle_mode:
            # Lists that never clicked are masked out; labels past the
            # cutoff are zero.
            clicked = got["labels"].sum(dim=1) > 0
            assert (got["mask"][~clicked] == 0).all()
        assert (got["labels"][:, CUT:] == 0).all()


def test_deterministic_rank_equals_jax(click_json):
    jax_feed, jax_state, feed, _ = _pair(FEEDS[0],
                                         f"click_model_json={click_json}")
    _, scores, ranking, _ = _jax_draws(jax_feed, jax_state,
                                       jax.random.PRNGKey(5))
    qs = np.array(jax.random.randint(jax.random.split(
        jax.random.PRNGKey(5), 3)[0], (B,), 0, Q))
    mask = feed.dataset.gather(torch.from_numpy(qs))["mask"]
    got = feed._rank(None, torch.from_numpy(scores), mask)
    np.testing.assert_array_equal(got.numpy(), ranking)


def test_port_scores_and_train_batch(click_json):
    """The port's ``train_batch``: the ranker's scores equal JAX's on the
    same queries, and the deterministic feed shows each list in
    descending score order with clicks only on the top CUT."""
    jax_feed, jax_state, feed, state = _pair(
        FEEDS[0], f"click_model_json={click_json}")
    _, want, _, _ = _jax_draws(jax_feed, jax_state, jax.random.PRNGKey(1))
    qs = np.array(jax.random.randint(jax.random.split(
        jax.random.PRNGKey(1), 3)[0], (B,), 0, Q))
    got = feed.algorithm.score(state, feed.dataset.gather(
        torch.from_numpy(qs)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)

    batch = feed.train_batch(torch.Generator().manual_seed(0), state)
    shown = feed.algorithm.score(state, batch)
    assert batch["features"].shape == (B, LC, F)
    assert (batch["labels"][:, CUT:] == 0).all()
    clicked = batch["labels"].sum(dim=1) > 0
    assert (batch["mask"][~clicked] == 0).all()
    listed = batch["mask"] > 0
    for row in range(B):
        s = shown[row][listed[row]]
        assert (s[1:] <= s[:-1]).all()


def test_stochastic_first_pick_follows_softmax(click_json):
    """20,000 draws of one list of six documents (one padded) at tau 0.5:
    each document's share of the first position within 4 sigma of
    softmax(tau * s)."""
    _, _, feed, _ = _pair(FEEDS[1], f"click_model_json={click_json},tau=0.5")
    n = 20000
    s = torch.tensor([1.5, 0.2, -0.4, 0.9, 3.0, 0.0])
    mask = torch.tensor([1.0, 1.0, 1.0, 1.0, 1.0, 0.0])
    ranking = feed._rank(torch.Generator().manual_seed(3),
                         s.expand(n, -1), mask.expand(n, -1))
    share = torch.bincount(ranking[:, 0], minlength=6).double() / n
    p = torch.softmax(0.5 * s[:5].double(), dim=0)
    sigma = (p * (1 - p) / n).sqrt()
    assert share[5] == 0
    assert ((share[:5] - p).abs() < 4 * sigma).all(), (share, p)


@pytest.mark.parametrize("cls", FEEDS)
def test_online_feeds_accept_dynamic_bias_hparams(click_json, cls):
    """A reference-style online config with dynamic bias parses and
    schedules eta (the JAX package's test of the same name)."""
    hp = (f"click_model_json={click_json},"
          "dynamic_bias_eta_change=0.3,dynamic_bias_step_interval=20")
    _, _, feed, state = _pair(cls, hp)
    assert abs(float(feed._eta_at_steps(torch.tensor(0))) - 1.0) < 1e-6
    assert abs(float(feed._eta_at_steps(torch.tensor(45))) - 1.6) < 1e-6
    batch = feed.train_batch(torch.Generator().manual_seed(2), state)
    assert np.isfinite(batch["labels"].sum().item())


def test_online_feeds_cannot_plan(click_json):
    for cls in FEEDS:
        _, _, feed, _ = _pair(cls, f"click_model_json={click_json}")
        assert not feed.can_plan()
    direct = feeds.DirectLabelFeed(feed.algorithm, B, "", feed.dataset)
    assert direct.can_plan()
