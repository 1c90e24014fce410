"""Training with the new rankers and click models in the port against the
JAX package: three ``sgd`` steps of DLA + SetRank, DLA + DLCM, Naive +
GSF, Naive + Linear (also with ``norm=none``), DLA + DNN on UBM clicks
and Naive + DNN on cascade clicks.

Both start from the JAX package's initial state (the ranker's weights
moved off their init by a seeded perturbation, and DLA's propensity
tower), carried across by ``load_state_leaves``, and take three steps on
the same fixed numpy batches. The UBM and cascade batches carry the
clicks JAX's sampler gave on fixed labels, so the click models enter as
data. The port runs with its kernel hparams off and on
(``loss_func=fused_softmax_loss``, and ``use_pallas=true`` for the DNN:
on CPU tensors the kernels' plain versions behind their autograd
Functions); the JAX package runs its plain path. The losses of every step
and every state leaf at the end must agree to 1e-4.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX package is the reference here
pytest.importorskip("flax")  # its algorithms and click models need it

from ultra_pytorch_tpu.run.experiment import (  # noqa: E402
    create_algorithm as jax_create_algorithm)
from ultra_pytorch_tpu.sim import click_models as jax_cm  # noqa: E402
from ultra_pytorch_tpu_torch.run.experiment import (  # noqa: E402
    create_algorithm)

F, B, L = 12, 8, 10
STEPS = 3
TOL = 1e-4
# name -> (algorithm, ranker, ranker hparams, click model or None)
RUNS = {
    "dla_setrank": ("DLA", "SetRank",
                    "d_model=16,num_heads=4,num_layers=2,diff=8", None),
    "dla_dlcm": ("DLA", "DLCM", "embed_size=8,hidden_size=6", None),
    "naive_gsf": ("NaiveAlgorithm", "GSF",
                  "group_size=2,hidden_layer_sizes=[16]", None),
    "naive_linear": ("NaiveAlgorithm", "Linear", "", None),
    # norm=none leaves the input LayerNorm out of the loss: its gradient
    # is JAX's zeros, not a missing one.
    "naive_linear_no_norm": ("NaiveAlgorithm", "Linear", "norm=none", None),
    "dla_ubm": ("DLA", "DNN", "hidden_layer_sizes=[16, 8]", "ubm"),
    "naive_cascade": ("NaiveAlgorithm", "DNN", "hidden_layer_sizes=[16, 8]",
                      "cascade"),
}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _settings(run, kernels):
    algo, ranker, ranker_hp, _ = RUNS[run]
    algo_hp = "grad_strategy=sgd"
    if kernels:
        algo_hp += ",loss_func=fused_softmax_loss"
        if ranker == "DNN":
            ranker_hp += ",use_pallas=true"
    return {"ranking_model": ranker, "ranking_model_hparams": ranker_hp,
            "learning_algorithm": algo,
            "learning_algorithm_hparams": algo_hp,
            "max_candidate_num": L, "selection_bias_cutoff": L,
            "metrics": ["ndcg"], "metrics_topn": [5]}


def _batches(click_model):
    """Fixed batches with padded lists: PBM-like clicks (always one on the
    first document), or the clicks JAX's UBM / cascade sampler gives."""
    rng = np.random.default_rng(0)
    out = []
    for i in range(STEPS):
        mask = np.ones((B, L), np.float32)
        for b in range(B):
            mask[b, rng.integers(4, L + 1):] = 0.0
        if click_model is None:
            clicks = (rng.random((B, L)) < 0.3).astype(np.float32) * mask
            clicks[:, 0] = 1.0
        else:
            labels = rng.integers(0, 5, size=(B, L)).astype(np.float32)
            model = jax_cm.make_click_model(click_model, 0.1, 1.0, 4, 1.0)
            clicks = np.array(jax_cm.sample_clicks(
                model, jax.random.PRNGKey(i), labels, mask)[0])
        out.append({
            "features": rng.normal(size=(B, L, F)).astype(np.float32),
            "labels": clicks, "mask": mask,
            "initial_scores": np.zeros((B, L), np.float32)})
    return out


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


@pytest.fixture(scope="module")
def jax_runs():
    """run -> (initial state, per-step metrics, final leaves)."""
    runs = {}
    for run, (_, _, _, click_model) in RUNS.items():
        alg = jax_create_algorithm(_settings(run, False), F, 1.0)
        state0 = alg.init_state(jax.random.PRNGKey(0), F)
        rng = np.random.default_rng(1)
        state0 = state0.replace(params=jax.tree_util.tree_map(
            lambda a: (np.asarray(a) + 0.2 * rng.normal(size=np.shape(a))
                       ).astype(np.float32), state0.params))
        step = jax.jit(alg.train_step)
        state, history = state0, []
        for i, batch in enumerate(_batches(click_model)):
            state, metrics = step(state, batch, jax.random.PRNGKey(100 + i))
            history.append({k: float(v) for k, v in metrics.items()})
        runs[run] = (state0, history, _leaves(state))
    return runs


@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "kernels"])
@pytest.mark.parametrize("run", list(RUNS))
def test_three_sgd_steps_match_jax(jax_runs, run, kernels):
    state0, want_history, want = jax_runs[run]
    alg = create_algorithm(_settings(run, kernels), F, 1.0, device="cpu")
    state = alg.load_state_leaves(
        alg.init_state(torch.Generator().manual_seed(0)), _leaves(state0))
    for batch, want_metrics in zip(_batches(RUNS[run][3]), want_history):
        state, metrics = alg.train_step(
            state, {k: torch.from_numpy(v) for k, v in batch.items()})
        for k, v in want_metrics.items():
            np.testing.assert_allclose(metrics[k].item(), v, rtol=TOL,
                                       atol=TOL, err_msg=k)
    assert state.step == STEPS
    got = alg.state_leaves(state)
    assert [np.shape(a) for a in got] == [np.shape(b) for b in want]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)


def test_click_batches_exercise_the_click_models():
    """The UBM batches click more than once in some list; the cascade
    batches never do."""
    ubm = np.stack([b["labels"] for b in _batches("ubm")])
    cascade = np.stack([b["labels"] for b in _batches("cascade")])
    assert ubm.sum(-1).max() > 1
    assert cascade.sum(-1).max() == 1
