"""The offline debiasing family in the port against the JAX package:
Naive, IPW, Regression-EM, PairDebias, LambdaRank and PRS.

Both start from the JAX package's initial state (the ranker, with its
LayerNorm affine moved away from ones/zeros as after training, and the
aux state), carried across leaf for leaf by ``load_state_leaves``, and
take steps on the same fixed numpy batches. The port runs with its kernel
hparams off and on (``use_pallas=true``, and ``loss_func=
fused_softmax_loss`` for the two softmax algorithms: on CPU tensors the
kernels' plain versions behind their autograd Functions); the JAX package
runs its plain path. Regression-EM's Bernoulli uniforms are JAX's own
(``jax.random.uniform`` of the step's rng, which ``per_shard_rng`` leaves
as it is on one device), fed to ``step_with_uniforms``.

Everything must agree to 1e-4. A trap: Adagrad's first step is ``-lr * g
/ (|g| + 1e-10)``, so a gradient within float noise of 0 becomes a full
step of either sign. The softmax losses of Naive and IPW and the pairwise
losses of PairDebias, LambdaRank and PRS are shift-invariant, so the
output bias (and the LayerNorm bias in front of it) has such a gradient.
So every algorithm is compared at the gradient level at step 1 and over
three steps of ``sgd``; three steps of ``ada`` only with ``l2_loss=1e-3``
(which gives those biases a real gradient), for the four algorithms whose
hparams have ``l2_loss``.
"""

import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX package is the reference here
pytest.importorskip("flax")  # its algorithms need it

from ultra_pytorch_tpu.run.experiment import (  # noqa: E402
    create_algorithm as jax_create_algorithm)
from ultra_pytorch_tpu_torch.run.experiment import (  # noqa: E402
    create_algorithm)
from ultra_pytorch_tpu_torch.sim.click_models import (  # noqa: E402
    click_model_json_numpy)

F, B, L = 12, 8, 10
STEPS = 3
TOL = 1e-4
ALGORITHMS = ("NaiveAlgorithm", "IPWrank", "RegressionEM", "PairDebias",
              "LambdaRank", "PRSrank")
WITH_L2 = ("NaiveAlgorithm", "IPWrank", "RegressionEM", "PairDebias")
SOFTMAX = ("NaiveAlgorithm", "IPWrank")
KERNELS = pytest.mark.parametrize("kernels", [False, True],
                                  ids=["plain", "kernels"])


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def estimator_json(tmp_path_factory):
    """A randomized estimator's JSON whose table is shorter than the list
    (positions beyond it take its last entry)."""
    path = tmp_path_factory.mktemp("estimator") / "randomized_pbm.json"
    path.write_text(json.dumps({
        "IPW_list": [1.0, 1.11, 1.42, 2.0, 2.43, 3.41, 6.17, 6.8],
        "click_model": click_model_json_numpy("pbm", 0.1, 1.0, 4, 1.0)}))
    return str(path)


def _settings(algo, grad_strategy, kernels, estimator_json, l2=False):
    ranker = "hidden_layer_sizes=[16, 8]"
    hp = [f"grad_strategy={grad_strategy}"]
    if l2:
        hp.append("l2_loss=0.001")
    if algo in ("IPWrank", "PRSrank"):
        hp.append(f"propensity_estimator_json={estimator_json}")
    if kernels:
        ranker += ",use_pallas=true"
        if algo in SOFTMAX:
            hp.append("loss_func=fused_softmax_loss")
    return {"ranking_model": "DNN", "ranking_model_hparams": ranker,
            "learning_algorithm": algo,
            "learning_algorithm_hparams": ",".join(hp),
            "max_candidate_num": L, "selection_bias_cutoff": L,
            "metrics": ["ndcg"], "metrics_topn": [5]}


def _batches(scale=1.0):
    rng = np.random.default_rng(0)
    out = []
    for _ in range(STEPS):
        mask = np.ones((B, L), np.float32)
        for b in range(B):
            mask[b, rng.integers(4, L + 1):] = 0.0
        clicks = (rng.random((B, L)) < 0.3).astype(np.float32) * mask
        clicks[:, 0] = 1.0
        out.append({
            "features": (scale * rng.normal(size=(B, L, F))).astype(
                np.float32),
            "labels": clicks, "mask": mask,
            "initial_scores": np.zeros((B, L), np.float32)})
    return out


def _rng(i):
    return jax.random.PRNGKey(100 + i)


def _uniforms(i):
    """The uniforms the JAX Regression-EM draws at step i."""
    return np.array(jax.random.uniform(_rng(i), (B, L)))


def _perturbed_norms(params, out_scale=1.0):
    """The LayerNorm affine away from ones/zeros, as after training; the
    output layer's weights times `out_scale`."""
    rng = np.random.default_rng(1)
    layers = []
    for j, layer in enumerate(params["layers"]):
        n = layer["norm"]["scale"].shape[0]
        linear = dict(layer["linear"])
        if j == len(params["layers"]) - 1:
            linear["w"] = np.asarray(linear["w"]) * out_scale
        layers.append({"linear": linear, "norm": {
            "scale": (1 + 0.2 * rng.normal(size=n)).astype(np.float32),
            "bias": (0.2 * rng.normal(size=n)).astype(np.float32)}})
    return {"layers": layers}


def _jax_init(algo, grad_strategy, estimator_json, l2, out_scale=1.0):
    alg = jax_create_algorithm(
        _settings(algo, grad_strategy, False, estimator_json, l2), F, 1.0)
    state0 = alg.init_state(jax.random.PRNGKey(0), F)
    return alg, state0.replace(
        params=_perturbed_norms(state0.params, out_scale))


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _port(algo, grad_strategy, kernels, estimator_json, l2, state0):
    """The port's algorithm and a state loaded from the JAX state."""
    alg = create_algorithm(
        _settings(algo, grad_strategy, kernels, estimator_json, l2), F, 1.0,
        device="cpu")
    state = alg.load_state_leaves(
        alg.init_state(torch.Generator().manual_seed(0)), _leaves(state0))
    return alg, state


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _port_step(alg, state, batch, i):
    if alg.name == "regression_em":
        return alg.step_with_uniforms(state, _torch_batch(batch),
                                      torch.from_numpy(_uniforms(i)))
    return alg.train_step(state, _torch_batch(batch))


def _jax_trajectory(algo, grad_strategy, estimator_json, l2):
    alg, state0 = _jax_init(algo, grad_strategy, estimator_json, l2)
    step = jax.jit(alg.train_step)
    state, losses = state0, []
    for i, batch in enumerate(_batches()):
        state, metrics = step(state, batch, _rng(i))
        losses.append(float(metrics["loss"]))
    return state0, losses, _leaves(state)


@pytest.fixture(scope="module")
def jax_runs(estimator_json):
    """(algo, grad_strategy) -> (initial state, losses, final leaves)."""
    runs = {}
    for algo in ALGORITHMS:
        runs[algo, "sgd"] = _jax_trajectory(algo, "sgd", estimator_json,
                                            False)
    for algo in WITH_L2:
        runs[algo, "ada"] = _jax_trajectory(algo, "ada", estimator_json,
                                            True)
    return runs


def _jax_first_step(algo, estimator_json, out_scale=1.0, scale=1.0):
    """The JAX step 1 run eagerly with its gradients captured on their
    way into the optimizer: (initial state, loss, gradient leaves)."""
    alg, state0 = _jax_init(algo, "sgd", estimator_json, False, out_scale)
    captured = []
    apply_updates = alg.apply_updates

    def capture(opt, params, opt_state, grads):
        captured.append(grads)
        return apply_updates(opt, params, opt_state, grads)

    alg.apply_updates = capture
    _, metrics = alg.train_step(state0, _batches(scale)[0], _rng(0))
    return state0, float(metrics["loss"]), _leaves(captured[0])


def _check_first_step(algo, kernels, estimator_json, out_scale=1.0,
                      scale=1.0):
    state0, want_loss, want_grads = _jax_first_step(
        algo, estimator_json, out_scale, scale)
    alg, state = _port(algo, "sgd", kernels, estimator_json, False, state0)
    batch = _torch_batch(_batches(scale)[0])
    extra = (torch.from_numpy(_uniforms(0)),) if algo == "RegressionEM" \
        else ()
    out = alg.losses(state, batch, *extra)
    grads = torch.autograd.grad(out[0], alg.trainable(state))
    np.testing.assert_allclose(out[0].item(), want_loss, rtol=TOL, atol=TOL)
    assert len(grads) == len(want_grads)
    for g, (_, transposed), want in zip(grads, state.params.jax_leaves(),
                                        want_grads):
        got = (g.t() if transposed else g).numpy()
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    return state, batch


@KERNELS
@pytest.mark.parametrize("algo", ALGORITHMS)
def test_first_step_loss_and_gradients_match_jax(estimator_json, algo,
                                                 kernels):
    _check_first_step(algo, kernels, estimator_json)


def _check_trajectory(jax_runs, algo, grad_strategy, kernels,
                      estimator_json):
    state0, want_losses, want = jax_runs[algo, grad_strategy]
    alg, state = _port(algo, grad_strategy, kernels, estimator_json,
                       grad_strategy == "ada", state0)
    for i, (batch, want_loss) in enumerate(zip(_batches(), want_losses)):
        state, metrics = _port_step(alg, state, batch, i)
        np.testing.assert_allclose(metrics["loss"].item(), want_loss,
                                   rtol=TOL, atol=TOL)
    assert state.step == STEPS
    got = alg.state_leaves(state)
    assert [np.shape(a) for a in got] == [np.shape(b) for b in want]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)


@KERNELS
@pytest.mark.parametrize("algo", ALGORITHMS)
def test_three_sgd_steps_match_jax(jax_runs, estimator_json, algo, kernels):
    """Params, optimizer state, aux state and losses over three steps."""
    _check_trajectory(jax_runs, algo, "sgd", kernels, estimator_json)


@KERNELS
@pytest.mark.parametrize("algo", WITH_L2)
def test_three_adagrad_steps_with_l2_match_jax(jax_runs, estimator_json,
                                               algo, kernels):
    _check_trajectory(jax_runs, algo, "ada", kernels, estimator_json)


@pytest.mark.parametrize("algo", ALGORITHMS)
def test_state_leaves_follow_the_jax_train_state(estimator_json, algo):
    """The checkpoint leaf order: ranker, flat optimizer, aux (keys
    sorted; None has no leaf), step; loaded and read back unchanged."""
    l2 = algo in WITH_L2
    _, state0 = _jax_init(algo, "ada", estimator_json, l2)
    alg, state = _port(algo, "ada", False, estimator_json, l2, state0)
    mine, theirs = alg.state_leaves(state), _leaves(state0)
    assert [np.shape(a) for a in mine] == [np.shape(b) for b in theirs]
    for a, b in zip(mine, theirs):
        np.testing.assert_array_equal(a, b)
    n_aux = {"NaiveAlgorithm": 0, "IPWrank": 0, "PRSrank": 0,
             "RegressionEM": 1, "PairDebias": 2, "LambdaRank": 2}[algo]
    n_ranker = len(state.params.jax_leaves())
    assert len(mine) == n_ranker + 1 + n_aux + 1   # + Adagrad acc + step


@KERNELS
def test_prs_gradient_with_a_saturated_pair_matches_jax(estimator_json,
                                                        kernels):
    """Scores 20 and more apart: sigmoid(s_i - s_j) is exactly 1.0 in
    float32, where the clip's gradient at its bound must split as
    ``jnp.clip``'s does."""
    state, batch = _check_first_step("PRSrank", kernels, estimator_json,
                                     out_scale=60.0, scale=2.0)
    with torch.no_grad():
        s = state.params(batch["features"], batch["mask"])
    gaps = (s[:, :, None] - s[:, None, :]).abs()
    assert gaps.max().item() > 20.0
    assert bool((torch.sigmoid(gaps) == 1.0).any())


def test_regression_em_draws_its_uniforms_from_the_generator(
        estimator_json):
    """train_step takes ``torch.rand`` of the training list's shape from
    the generator it is given, and nothing else from it."""
    _, state0 = _jax_init("RegressionEM", "sgd", estimator_json, False)
    batch = _torch_batch(_batches()[0])
    results = []
    for via_generator in (True, False):
        alg, state = _port("RegressionEM", "sgd", False, estimator_json,
                           False, state0)
        gen = torch.Generator().manual_seed(9)
        if via_generator:
            state, metrics = alg.train_step(state, batch, gen)
        else:
            u = torch.rand((B, L), generator=gen)
            state, metrics = alg.step_with_uniforms(state, batch, u)
        results.append(alg.state_leaves(state) + [gen.get_state().numpy()])
    for a, b in zip(*results):
        np.testing.assert_array_equal(a, b)
