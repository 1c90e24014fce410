"""The port's data parallelism against the JAX package's.

* ``shard_queries_for_host`` gives the JAX package's stripes, array for
  array.
* Two gloo ranks on the CPU take steps on given per-shard batches (and,
  for Regression-EM, the uniforms JAX draws from ``fold_in(k_train,
  shard)``), against JAX's ``shard_map`` step on a 2-device mesh with the
  algorithm's ``grad_sync`` bound to ``lax.pmean`` and ``shard_rng`` to
  the fold, as ``make_dp_train_step`` binds them. ``sgd`` with a clip
  bound that binds: clipping each rank's gradient before the average
  would give another update. The same given batches as one window
  (``make_dp_train_step(window=W)``'s shape: the steps, then the window
  means averaged over the ranks), run by ``dp_train_steps`` and by the
  body that ``run/window.WindowGraphs`` captures on the card, run eagerly
  here: both bit-identical, and equal to JAX's steps.
* MGD and NSGD windows through the Experiment keep their parameters and
  NSGD's memory bit-identical on both ranks; the two ranks draw different
  batches; ``shard_data`` keeps each rank's stripe.
* The rankers and the estimator-driven algorithms the same way: IPWrank
  and PRSrank with the estimator's JSON, DLA + DLCM, Naive + GSF and
  DLA + SetRank at dropout rate 0, given batches against ``shard_map``.
* The steps that draw from their own generators cannot match JAX's
  threefry streams, so they are held by properties (``RECORDED``: PDGD
  on both feeds, DBGD, DLA + SetRank at rate 0.1, PDGD with
  ``shard_data`` on the stochastic online feed): the state bit-identical
  across ranks, each rank's own draws (its batches, its dropout) unlike
  the other's, the replica draws (DBGD's noises) alike, and a group of
  one rank bit for bit the run without a group.

All the port's ranks run in one process group (one spawn, a ``file://``
rendezvous in ``tmp_path``, joined with a time limit).
"""

from functools import partial

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")   # the JAX package is the reference here
pytest.importorskip("flax")        # its algorithms need it

from jax.sharding import PartitionSpec as P  # noqa: E402

import os  # noqa: E402

from ultra_pytorch_tpu.data import dataset as jax_data  # noqa: E402
from ultra_pytorch_tpu.parallel import make_mesh  # noqa: E402
from ultra_pytorch_tpu.parallel import (  # noqa: E402
    shard_queries_for_host as jax_shard_queries)
from ultra_pytorch_tpu.run.experiment import (  # noqa: E402
    create_algorithm as jax_create_algorithm)
from ultra_pytorch_tpu_torch.data import dataset as data_lib  # noqa: E402
from ultra_pytorch_tpu_torch.input_layer.feeds import (  # noqa: E402
    DirectLabelFeed)
from ultra_pytorch_tpu_torch.parallel import (  # noqa: E402
    shard_generator, shard_queries_for_host, spawn_ranks)
from ultra_pytorch_tpu_torch.run.experiment import (  # noqa: E402
    Experiment, create_algorithm, resolve_dp)

import torch_dp_ranks  # noqa: E402

F, B, L = 12, 8, 10        # B is the global batch: 4 queries a shard
WORLD = 2
STEPS = 2
MAX_NORM = 0.01            # binds: the mean gradient's norm is above it
LR = 1.0
TOL = 1e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ESTIMATOR = ("propensity_estimator_json=" + os.path.join(
    ROOT, "example", "PropensityEstimator",
    "randomized_pbm_0.1_1.0_4_1.0.json"))
DNN = ("DNN", "hidden_layer_sizes=[16, 8]")
SETRANK = "d_model=16,num_heads=2,num_layers=1,diff=8,rate={}"
# name -> (algorithm, its hparams beyond the step's, ranker, its hparams)
GIVEN = {
    "DLA": ("DLA", "") + DNN,
    "NaiveAlgorithm": ("NaiveAlgorithm", "loss_func=sigmoid_loss") + DNN,
    "RegressionEM": ("RegressionEM", "") + DNN,
    "PairDebias": ("PairDebias", "") + DNN,
    "LambdaRank": ("LambdaRank", "") + DNN,
    "IPWrank": ("IPWrank", ESTIMATOR) + DNN,
    "PRSrank": ("PRSrank", ESTIMATOR) + DNN,
    "DLA+DLCM": ("DLA", "", "DLCM", "embed_size=8,hidden_size=8"),
    "NaiveAlgorithm+GSF": ("NaiveAlgorithm", "", "GSF",
                           "group_size=2,hidden_layer_sizes=[16]"),
    "DLA+SetRank": ("DLA", "", "SetRank", SETRANK.format(0)),
}
# The ones whose step draws nothing of its own, so a window on the given
# batches is JAX's steps (Regression-EM's uniforms come from the window's
# shard generator).
GIVEN_WINDOWS = ("DLA", "NaiveAlgorithm", "PairDebias", "LambdaRank",
                 "IPWrank", "PRSrank", "DLA+DLCM", "NaiveAlgorithm+GSF",
                 "DLA+SetRank")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _settings(algo, extra="", ranker=DNN[0], ranker_hparams=DNN[1]):
    hp = [f"grad_strategy=sgd,learning_rate={LR},"
          f"max_gradient_norm={MAX_NORM}"] + ([extra] if extra else [])
    return {"ranking_model": ranker,
            "ranking_model_hparams": ranker_hparams,
            "learning_algorithm": algo,
            "learning_algorithm_hparams": ",".join(hp),
            "max_candidate_num": L, "selection_bias_cutoff": L,
            "metrics": ["ndcg"], "metrics_topn": [5]}


def _shard_batches(step):
    """Step `step`'s per-shard batches, each array ``[WORLD, B / WORLD,
    ...]``."""
    rng = np.random.default_rng(10 + step)
    mask = np.ones((B, L), np.float32)
    for b in range(B):
        mask[b, rng.integers(4, L + 1):] = 0.0
    clicks = (rng.random((B, L)) < 0.3).astype(np.float32) * mask
    clicks[:, 0] = 1.0
    batch = {"features": rng.normal(size=(B, L, F)).astype(np.float32),
             "labels": clicks, "mask": mask,
             "initial_scores": np.zeros((B, L), np.float32)}
    return {k: v.reshape((WORLD, B // WORLD) + v.shape[1:])
            for k, v in batch.items()}


def _k_train(step):
    return jax.random.PRNGKey(100 + step)


def _shard_uniforms(step):
    """Regression-EM's uniforms, as its JAX step draws them on each shard
    (``uniform(per_shard_rng(k_train))``, the fold of the shard index)."""
    return np.stack([np.asarray(jax.random.uniform(
        jax.random.fold_in(_k_train(step), r), (B // WORLD, L)))
        for r in range(WORLD)])


def _perturbed_norms(params):
    """The LayerNorm affine away from ones/zeros, as after training."""
    rng = np.random.default_rng(1)
    layers = []
    for layer in params["layers"]:
        n = layer["norm"]["scale"].shape[0]
        layers.append({"linear": dict(layer["linear"]), "norm": {
            "scale": (1 + 0.2 * rng.normal(size=n)).astype(np.float32),
            "bias": (0.2 * rng.normal(size=n)).astype(np.float32)}})
    return {"layers": layers}


def _jax_dp_run(name):
    """JAX's data-parallel steps on the given shard batches: (initial
    leaves, per-shard losses [STEPS, WORLD], final leaves)."""
    alg = jax_create_algorithm(_settings(*GIVEN[name]), F, 1.0)
    state = alg.init_state(jax.random.PRNGKey(0), F)
    if GIVEN[name][2] == "DNN":
        state = state.replace(params=_perturbed_norms(state.params))
    init = [np.asarray(x) for x in jax.tree_util.tree_leaves(state)]

    def body(state, rng, batch):
        batch = jax.tree_util.tree_map(lambda x: x[0], batch)
        idx = jax.lax.axis_index("data")
        alg.grad_sync = partial(jax.lax.pmean, axis_name="data")
        alg.shard_rng = lambda key: jax.random.fold_in(key, idx)
        try:
            state, metrics = alg.train_step(state, batch, rng)
        finally:
            alg.grad_sync = alg.shard_rng = None
        return state, metrics["loss"][None]

    step = jax.jit(jax.shard_map(
        body, mesh=make_mesh(WORLD), in_specs=(P(), P(), P("data")),
        out_specs=(P(), P("data")), check_vma=False))
    losses = []
    for i in range(STEPS):
        state, loss = step(state, _k_train(i), _shard_batches(i))
        losses.append(np.asarray(loss))
    return init, np.stack(losses), [np.asarray(x) for x in
                                   jax.tree_util.tree_leaves(state)]


def _window_settings(algo, click_model_json, feed="ClickSimulationFeed",
                     ranker="DNN", ranker_hparams="hidden_layer_sizes=[8]"):
    return {"train_input_feed": feed,
            "train_input_hparams": f"click_model_json={click_model_json}",
            "valid_input_feed": "DirectLabelFeed", "valid_input_hparams": "",
            "test_input_feed": "DirectLabelFeed", "test_input_hparams": "",
            "ranking_model": ranker,
            "ranking_model_hparams": ranker_hparams,
            "learning_algorithm": algo,
            "learning_algorithm_hparams":
                f"click_model_json={click_model_json}"
                if algo in ("MGD", "NSGD", "DBGD") else "",
            "metrics": ["ndcg"], "metrics_topn": [5],
            "objective_metric": "ndcg_5", "selection_bias_cutoff": 5}


def _recorded(click_model_json):
    """The steps that draw from their own generators: name -> (settings,
    steps, shard_data)."""
    online = "StochasticOnlineSimulationFeed"
    return {
        "PDGD": (_window_settings("PDGD", click_model_json), 2, False),
        "PDGD online": (_window_settings("PDGD", click_model_json, online),
                        2, False),
        "DBGD": (_window_settings("DBGD", click_model_json,
                                  "DeterministicOnlineSimulationFeed"),
                 2, False),
        "DLA+SetRank rate 0.1": (_window_settings(
            "DLA", click_model_json, ranker="SetRank",
            ranker_hparams=SETRANK.format(0.1)), 2, False),
        "PDGD online shard_data": (_window_settings(
            "PDGD", click_model_json, online), 2, True),
    }


RECORDED = ("PDGD", "PDGD online", "DBGD", "DLA+SetRank rate 0.1",
            "PDGD online shard_data")


@pytest.fixture(scope="module")
def jax_runs():
    return {name: _jax_dp_run(name) for name in GIVEN}


@pytest.fixture(scope="module")
def ranks(jax_runs, toy_data_dir, click_model_json, tmp_path_factory):
    """Both ranks' results of every job, from one process group."""
    given = {}
    for name, (init, _, _) in jax_runs.items():
        steps = [(_shard_batches(i),
                  _shard_uniforms(i) if name == "RegressionEM" else None)
                 for i in range(STEPS)]
        given[name] = (_settings(*GIVEN[name]), init, steps, F)
    online = "StochasticOnlineSimulationFeed"
    windows = {
        "MGD": (_window_settings("MGD", click_model_json, online), 2, False),
        "NSGD": (_window_settings("NSGD", click_model_json, online), 2,
                 False),
        "DLA window": (_window_settings("DLA", click_model_json), 3, False),
        "DLA stripes": (_window_settings("DLA", click_model_json), 1, True),
    }
    store = tmp_path_factory.mktemp("rendezvous") / "store"
    return spawn_ranks(torch_dp_ranks.rank_job, WORLD,
                       (f"file://{store}", given, toy_data_dir, windows,
                        "cpu", GIVEN_WINDOWS, None,
                        _recorded(click_model_json)), timeout=240)


@pytest.fixture(scope="module")
def one_rank(toy_data_dir, click_model_json, tmp_path_factory):
    """Each recorded job as the one rank of a gloo group and without a
    group."""
    store = tmp_path_factory.mktemp("rendezvous1") / "store"
    return spawn_ranks(torch_dp_ranks.one_rank_job, 1,
                       (f"file://{store}", toy_data_dir,
                        _recorded(click_model_json)), timeout=240)[0]


def _toy(toy_data_dir, pkg):
    ds = pkg.read_data(toy_data_dir, "train")
    ds.pad(10)
    return ds


# -- stripes --------------------------------------------------------------

@pytest.mark.parametrize("n_queries,n_hosts",
                         [(13, 3), (13, 4), (9, 8), (24, 3)])
def test_stripes_equal_the_jax_package(n_queries, n_hosts):
    rng = np.random.default_rng(n_queries * 10 + n_hosts)
    lengths = rng.integers(2, 6, size=n_queries)
    il = -np.ones((n_queries, 5), np.int64)
    start = 0
    for q, n in enumerate(lengths):
        il[q, :n] = np.arange(start, start + n)
        start += n
    args = dict(
        features=rng.normal(size=(start, 4)).astype(np.float32),
        initial_list=il,
        labels=rng.integers(0, 3, size=(n_queries, 5)).astype(np.float32),
        qids=[f"q{q}" for q in range(n_queries)],
        dids=[f"d{d}" for d in range(start)], feature_size=4,
        rank_list_size=5, max_label=2.0,
        initial_scores=rng.normal(size=(n_queries, 5)).astype(np.float32))
    for h in range(n_hosts):
        want = jax_shard_queries(jax_data.RankingDataset(**args), h, n_hosts)
        got = shard_queries_for_host(data_lib.RankingDataset(**args), h,
                                     n_hosts)
        assert got.qids == want.qids and got.dids == want.dids
        for name in ("features", "initial_list", "labels", "initial_scores",
                     "initial_list_lengths"):
            np.testing.assert_array_equal(getattr(got, name),
                                          getattr(want, name))


# -- the dp policy --------------------------------------------------------

def test_dp_policy_and_its_errors(toy_data_dir):
    assert resolve_dp("off", 16, "cpu") == resolve_dp(1, 16, "cpu") == 1
    assert resolve_dp("auto", 16, "cpu") == 1      # CPU: no group by default
    assert resolve_dp("4", 16, "cpu") == 4
    with pytest.raises(ValueError, match="not divisible by dp=3"):
        resolve_dp(3, 16, "cpu")
    settings = _window_settings("DLA", "unused")
    with pytest.raises(ValueError, match="needs a process group of 2"):
        Experiment(dict(settings), toy_data_dir, "unused", dp=2,
                   device="cpu")
    with pytest.raises(ValueError, match="--shard_data requires"):
        Experiment(dict(settings), toy_data_dir, "unused", shard_data=True,
                   device="cpu")


def test_feed_batch_must_divide_by_the_ranks(toy_data_dir):
    ds = _toy(toy_data_dir, data_lib).to_device("cpu")
    alg = create_algorithm(_settings("NaiveAlgorithm"), ds.feature_size,
                           1.0, device="cpu")
    with pytest.raises(ValueError, match="not divisible by 3"):
        DirectLabelFeed(alg, 16, "", ds, world_size=3)
    feed = DirectLabelFeed(alg, 16, "", ds, world_size=4)
    assert feed.batch_size == 4 and feed.eval_batch_size == 16


def test_shard_generator_is_the_replica_one_for_one_rank():
    gen = torch.Generator().manual_seed(5)
    assert shard_generator(gen, 0, 1) is gen
    seeds = {shard_generator(gen, r, 2).initial_seed() for r in range(2)}
    assert len(seeds) == 2 and gen.initial_seed() not in seeds


# -- steps on given batches -----------------------------------------------

@pytest.mark.parametrize("algo", list(GIVEN))
def test_two_rank_step_equals_jax_shard_map(jax_runs, ranks, algo):
    init, want_losses, want = jax_runs[algo]
    for rank, result in enumerate(ranks):
        losses, leaves = result[algo]
        np.testing.assert_allclose(losses, want_losses[:, rank], rtol=TOL,
                                   atol=1e-6)
        assert [np.shape(a) for a in leaves] == [np.shape(b) for b in want]
        for a, b in zip(leaves, want):
            np.testing.assert_allclose(a, b, rtol=TOL, atol=1e-6)
    # The update itself (clip after the average): each parameter's change
    # within 1e-3 of the largest change; clipping each rank's gradient
    # first would move it by O(1) of that.
    n = len(init)
    delta = [a - b for a, b in zip(ranks[0][algo][1][:n], init)]
    want_delta = [a - b for a, b in zip(want[:n], init)]
    scale = max(np.abs(d).max() for d in want_delta)
    assert scale > 0
    for a, b in zip(delta, want_delta):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-3 * scale)


@pytest.mark.parametrize("algo", GIVEN_WINDOWS)
def test_two_rank_window_equals_jax_shard_map(jax_runs, ranks, algo):
    """The given batches as one data-parallel window on each rank: the
    eager window and the graph's body alike bit for bit, the window's
    mean loss JAX's mean over its steps and shards, the state JAX's."""
    _, want_losses, want = jax_runs[algo]
    for result in ranks:
        runs = result[f"{algo} given window"]
        (eager_metrics, eager), (body_metrics, body) = (
            runs["eager"], runs["graph body"])
        assert eager_metrics == body_metrics
        for a, b in zip(eager, body):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(eager_metrics["loss"], want_losses.mean(),
                                   rtol=TOL, atol=1e-6)
        assert [np.shape(a) for a in eager] == [np.shape(b) for b in want]
        for a, b in zip(eager, want):
            np.testing.assert_allclose(a, b, rtol=TOL, atol=1e-6)
    assert ranks[0][f"{algo} given window"]["eager"][0] == \
        ranks[1][f"{algo} given window"]["eager"][0]


# -- windows through the Experiment ---------------------------------------

@pytest.mark.parametrize("algo", ["MGD", "NSGD", "DLA window"])
def test_ranks_stay_bit_identical(ranks, algo):
    a, b = (r[algo] for r in ranks)
    assert len(a["leaves"]) == len(b["leaves"])
    for x, y in zip(a["leaves"], b["leaves"]):
        np.testing.assert_array_equal(x, y)
    assert a["metrics"] == b["metrics"]
    assert int(a["leaves"][-1]) == {"DLA window": 3}.get(algo, 2)
    if algo == "NSGD":   # its memory: one leaf a ranker leaf
        assert len(a["leaves"]) == 2 * len(ranks[0]["MGD"]["leaves"]) - 1


def test_ranks_draw_different_batches(ranks):
    a, b = (r["DLA window"] for r in ranks)
    assert a["batch_size"] == b["batch_size"] == B // WORLD
    assert a["plans"][0].shape == (3, B // WORLD)
    assert not np.array_equal(a["plans"][0], b["plans"][0])


def test_shard_data_keeps_each_ranks_stripe(ranks, toy_data_dir):
    full = data_lib.read_data(toy_data_dir, "train")
    whole = ranks[0]["DLA window"]
    assert whole["qids"] == full.qids   # without shard_data: everything
    for rank, result in enumerate(ranks):
        want = shard_queries_for_host(full, rank, WORLD)
        got = result["DLA stripes"]
        assert got["qids"] == want.qids
        np.testing.assert_array_equal(got["features"], want.features)
        assert got["features"].shape[0] < full.features.shape[0]


# -- steps that draw from their own generators ----------------------------

def _same(a, b):
    return len(a) == len(b) and all(np.array_equal(x, y)
                                    for x, y in zip(a, b))


@pytest.mark.parametrize("name", RECORDED)
def test_own_draws_keep_ranks_bit_identical(ranks, name):
    a, b = (r[name] for r in ranks)
    assert _same(a["leaves"], b["leaves"])
    assert a["metrics"] == b["metrics"]
    assert np.isfinite(a["metrics"]["loss"])
    assert int(a["leaves"][-1]) == 2


@pytest.mark.parametrize("name", RECORDED)
def test_each_rank_draws_its_own_batches(ranks, name):
    a, b = (r[name] for r in ranks)
    assert len(a["batches"]) == len(b["batches"]) > 0
    assert not _same(a["batches"], b["batches"])


def test_dbgd_noises_are_replica_draws(ranks):
    a, b = (r["DBGD"] for r in ranks)
    assert len(a["noises"]) == 2      # one draw a step
    for x, y in zip(a["noises"], b["noises"]):
        assert _same(x, y)


def test_setrank_dropout_draws_from_the_shard_generator(ranks):
    a, b = (r["DLA+SetRank rate 0.1"] for r in ranks)
    assert len(a["dropout"]) == len(b["dropout"]) > 0
    assert not _same(a["dropout"], b["dropout"])


@pytest.mark.parametrize("name", RECORDED)
def test_a_group_of_one_equals_no_group(one_rank, name):
    group, none = one_rank[name]["group"], one_rank[name]["none"]
    assert _same(group["leaves"], none["leaves"])
    assert group["metrics"] == none["metrics"]
    assert _same(group["batches"], none["batches"])
    assert _same(group["dropout"], none["dropout"])
    for x, y in zip(group["noises"], none["noises"]):
        assert _same(x, y)
