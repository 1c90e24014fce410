"""DLA in the port against DLA in the JAX package, three steps from one
initialisation.

Both start from the JAX package's ranker and propensity tower (carried
across by ``params_from_jax``) and take three steps on the same fixed
numpy batches, for each ``grad_strategy``. The port runs with its kernel
hparams off and on (``use_pallas=true`` and ``loss_func=
fused_softmax_loss``, which on CPU tensors are K1/K2's and K3/K4's plain
versions behind their autograd Functions); the JAX package runs its plain
path, which its own tests hold to its Pallas kernels.

The losses, both towers and both optimizer states must agree to 1e-4.
A trap: Adagrad's first step is ``-lr * g / (|g| + 1e-10)``, so a
gradient within float noise of 0 becomes a full step of either sign. The
softmax loss is shift-invariant, so the output layer's bias, and the bias
of the LayerNorm in front of it (whose gradient is ``w * sum(dz)``), have
such gradients. ``l2_loss=1e-3`` gives each a real one (``1e-3 * b``, far
above the noise) once the LayerNorm affine starts away from its
ones/zeros init, as it is here. No other gradient here is near 0.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX package is the reference here
pytest.importorskip("flax")  # its click models and algorithms need it

from ultra_pytorch_tpu.run.experiment import (
    create_algorithm as jax_create_algorithm)
from ultra_pytorch_tpu_torch.algorithms import dla
from ultra_pytorch_tpu_torch.run.experiment import create_algorithm

F, B, L = 12, 8, 10
STEPS = 3
TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _settings(grad_strategy, kernels):
    ranker = "hidden_layer_sizes=[16, 8]"
    algo = f"grad_strategy={grad_strategy},l2_loss=0.001"
    if kernels:
        ranker += ",use_pallas=true"
        algo += ",loss_func=fused_softmax_loss"
    return {"ranking_model": "DNN", "ranking_model_hparams": ranker,
            "learning_algorithm": "DLA", "learning_algorithm_hparams": algo,
            "max_candidate_num": L, "selection_bias_cutoff": L,
            "metrics": ["ndcg"], "metrics_topn": [5]}


def _batches():
    rng = np.random.default_rng(0)
    out = []
    for _ in range(STEPS):
        mask = np.ones((B, L), np.float32)
        for b in range(B):
            mask[b, rng.integers(4, L + 1):] = 0.0
        clicks = (rng.random((B, L)) < 0.3).astype(np.float32) * mask
        clicks[:, 0] = 1.0
        out.append({
            "features": rng.normal(size=(B, L, F)).astype(np.float32),
            "labels": clicks, "mask": mask,
            "initial_scores": np.zeros((B, L), np.float32)})
    return out


def _perturbed_norms(params):
    """The LayerNorm affine away from ones/zeros, as after training."""
    rng = np.random.default_rng(1)
    layers = []
    for layer in params["layers"]:
        n = layer["norm"]["scale"].shape[0]
        layers.append({"linear": layer["linear"], "norm": {
            "scale": (1 + 0.2 * rng.normal(size=n)).astype(np.float32),
            "bias": (0.2 * rng.normal(size=n)).astype(np.float32)}})
    return {"layers": layers}


@pytest.fixture(scope="module")
def jax_runs():
    """grad_strategy -> (initial state, per-step metrics, final state)."""
    runs = {}
    for gs in ("ada", "ada_reset", "sgd"):
        alg = jax_create_algorithm(_settings(gs, False), F, 1.0)
        state0 = alg.init_state(jax.random.PRNGKey(0), F)
        state0 = state0.replace(params=_perturbed_norms(state0.params))
        step = jax.jit(alg.train_step)
        state, history = state0, []
        for batch in _batches():
            state, metrics = step(state, batch, jax.random.PRNGKey(1))
            history.append({k: float(v) for k, v in metrics.items()})
        runs[gs] = (jax.device_get(state0), history, jax.device_get(state))
    return runs


@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "kernels"])
@pytest.mark.parametrize("grad_strategy", ["ada", "ada_reset", "sgd"])
def test_three_steps_match_jax(jax_runs, grad_strategy, kernels):
    state0, want_history, want = jax_runs[grad_strategy]
    alg = create_algorithm(_settings(grad_strategy, kernels), F, 1.0,
                           device="cpu")
    state = alg.init_state(torch.Generator().manual_seed(0))
    dla.params_from_jax(state, state0.params, state0.aux["propensity"])
    for batch, want_metrics in zip(_batches(), want_history):
        state, metrics = alg.train_step(
            state, {k: torch.from_numpy(v) for k, v in batch.items()})
        for k, v in want_metrics.items():
            np.testing.assert_allclose(metrics[k].item(), v, rtol=TOL,
                                       atol=TOL, err_msg=k)
    assert state.step == STEPS
    got = dla.params_to_jax(state)
    for a, b in zip(jax.tree_util.tree_leaves(got["params"]),
                    jax.tree_util.tree_leaves(want.params)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=TOL, atol=TOL)
    for k in ("w", "b"):
        np.testing.assert_allclose(got["propensity"][k],
                                   np.asarray(want.aux["propensity"][k]),
                                   rtol=TOL, atol=TOL)
    opt = dla.opt_state_to_jax(state)
    want_opt = [jax.tree_util.tree_leaves(want.opt_state),
                jax.tree_util.tree_leaves(want.aux["prop_opt_state"])]
    for mine, theirs in zip((opt["ranker"], opt["propensity"]), want_opt):
        assert len(mine) == len(theirs)
        for a, b in zip(mine.values(), theirs):
            np.testing.assert_allclose(a, np.asarray(b), rtol=TOL, atol=TOL)


def test_state_leaves_follow_the_jax_train_state(jax_runs):
    """The checkpoint leaf order and shapes are the JAX TrainState's."""
    state0, _, _ = jax_runs["ada"]
    alg = create_algorithm(_settings("ada", False), F, 1.0, device="cpu")
    state = alg.init_state(torch.Generator().manual_seed(0))
    dla.params_from_jax(state, state0.params, state0.aux["propensity"])
    mine = alg.state_leaves(state)
    theirs = jax.tree_util.tree_leaves(state0)
    assert [np.shape(a) for a in mine] == [np.shape(b) for b in theirs]
    for a, b in zip(mine, theirs):
        np.testing.assert_array_equal(a, np.asarray(b))
    again = alg.load_state_leaves(
        alg.init_state(torch.Generator().manual_seed(1)), mine)
    for a, b in zip(alg.state_leaves(again), mine):
        np.testing.assert_array_equal(a, b)


def test_init_follows_the_seed():
    alg = create_algorithm(_settings("ada", False), F, 1.0, device="cpu")
    first = alg.state_leaves(alg.init_state(torch.Generator().manual_seed(4)))
    again = alg.state_leaves(alg.init_state(torch.Generator().manual_seed(4)))
    other = alg.state_leaves(alg.init_state(torch.Generator().manual_seed(5)))
    assert all(np.array_equal(a, b) for a, b in zip(first, again))
    assert not np.array_equal(first[1], other[1])


def test_optimizer_state_crosses_both_ways(jax_runs):
    """JAX's flat Adagrad accumulators load into the port and come back
    unchanged."""
    _, _, final = jax_runs["ada"]
    theirs = {name: {"sum_of_squares": np.asarray(
        jax.tree_util.tree_leaves(tree)[0])} for name, tree in (
            ("ranker", final.opt_state),
            ("propensity", final.aux["prop_opt_state"]))}
    alg = create_algorithm(_settings("ada", False), F, 1.0, device="cpu")
    state = dla.opt_state_from_jax(
        alg.init_state(torch.Generator().manual_seed(0)), theirs)
    back = dla.opt_state_to_jax(state)
    for name in theirs:
        np.testing.assert_array_equal(back[name]["sum_of_squares"],
                                      theirs[name]["sum_of_squares"])
