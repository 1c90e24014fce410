"""DLA's and Naive's other loss functions and hparams in the port against
the JAX package: three ``sgd`` steps from one initial state.

Both start from the JAX package's initial state (its ranker, with the
LayerNorm affine moved away from ones/zeros as after training, and DLA's
propensity tower), carried across leaf for leaf by ``load_state_leaves``,
and take three steps on the batches of ``test_torch_dla.py``. The losses
of every step and every state leaf at the end must agree to 1e-4. ``sgd``
keeps a gradient within float noise of 0 (the softmax loss's output bias)
a step within float noise of 0, as Adagrad's first step would not.

``softmax_cross_entropy_with_logits`` is no key of either package's loss
table: both fall back to ``softmax_loss``, and the case holds that they
fall back alike.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX package is the reference here
pytest.importorskip("flax")  # its algorithms need it

from ultra_pytorch_tpu.run.experiment import (  # noqa: E402
    create_algorithm as jax_create_algorithm)
from ultra_pytorch_tpu_torch.run.experiment import (  # noqa: E402
    create_algorithm)

F, B, L = 12, 8, 10
STEPS = 3
TOL = 1e-4
CASES = [
    ("DLA", "logits_to_prob=sigmoid"),
    ("DLA", "max_propensity_weight=2"),
    ("DLA", "propensity_learning_rate=0.2,ranker_loss_weight=0.5"),
    ("DLA", "constant_propensity_initialization=true"),
    ("DLA", "loss_func=sigmoid_loss"),
    ("DLA", "loss_func=pairwise_loss"),
    ("DLA", "loss_func=softmax_cross_entropy_with_logits"),
    ("NaiveAlgorithm", "loss_func=sigmoid_loss"),
    ("NaiveAlgorithm", "loss_func=pairwise_loss"),
]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _settings(algo, hparams):
    return {"ranking_model": "DNN",
            "ranking_model_hparams": "hidden_layer_sizes=[16, 8]",
            "learning_algorithm": algo,
            "learning_algorithm_hparams": f"grad_strategy=sgd,{hparams}",
            "max_candidate_num": L, "selection_bias_cutoff": L,
            "metrics": ["ndcg"], "metrics_topn": [5]}


def _batches():
    """The batches of ``test_torch_dla.py``."""
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


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


@pytest.mark.parametrize("algo,hparams", CASES)
def test_three_sgd_steps_match_jax(algo, hparams):
    settings = _settings(algo, hparams)
    jax_alg = jax_create_algorithm(settings, F, 1.0)
    state0 = jax_alg.init_state(jax.random.PRNGKey(0), F)
    state0 = state0.replace(params=_perturbed_norms(state0.params))
    step = jax.jit(jax_alg.train_step)
    jax_state, want_losses = state0, []
    for i, batch in enumerate(_batches()):
        jax_state, metrics = step(jax_state, batch, jax.random.PRNGKey(i))
        want_losses.append({k: float(v) for k, v in metrics.items()})

    alg = create_algorithm(settings, F, 1.0, device="cpu")
    state = alg.load_state_leaves(
        alg.init_state(torch.Generator().manual_seed(0)), _leaves(state0))
    for batch, want in zip(_batches(), want_losses):
        state, metrics = alg.train_step(
            state, {k: torch.from_numpy(v) for k, v in batch.items()})
        assert sorted(metrics) == sorted(want)
        for k, v in want.items():
            np.testing.assert_allclose(metrics[k].item(), v, rtol=TOL,
                                       atol=TOL, err_msg=k)
    got, want = alg.state_leaves(state), _leaves(jax_state)
    assert [np.shape(a) for a in got] == [np.shape(b) for b in want]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)
