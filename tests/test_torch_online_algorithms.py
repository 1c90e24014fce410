"""The online family in the port against the JAX package: the DBGD
family's noise utilities, PDGD, DBGD, MGD and NSGD.

Both packages start from the JAX package's initial state (the DNN's
LayerNorm affine moved away from ones/zeros, as after training), carried
across leaf for leaf by ``load_state_leaves``, and work on the same fixed
numpy batches of an online feed's layout (features of the whole
candidate list, clicks on the top L, ``relevance``).

* Noise: ``noise_spec`` equals JAX's on every ranker; ``unit_noise`` of
  JAX's own normals equals JAX's ``dbgd_noise_like`` within 1e-6 after
  the weight bridge.
* PDGD: the pair weights within 1e-5; one step's gradients and three
  steps' parameters and Adagrad vector within 1e-4 of their largest
  magnitude, kernel hparams off and on (on the CPU the kernels' plain
  versions behind their autograd Functions).
* DBGD, MGD and NSGD: JAX draws its noises and its winners inside the
  step, so the test patches the JAX instance's ``_sample_noises_with_state``
  and ``_interleave_winners`` and the port's ``sample_noises`` and
  ``interleave_winners`` to return the same ones; the parameters after a
  step agree within 1e-6, the loss within 1e-6. The winner inference
  given JAX's draft and click uniforms agrees (credit within 1e-7, clicks
  exactly, online nDCG within 1e-6). ``ndcg_winners`` takes ``ceil`` of a
  difference of two nDCGs, so a tie within one ulp could go either way:
  its test uses candidates whose nDCGs differ clearly, or are the same
  scores (an exact tie in both).
* NSGD's aux update given the win totals is exact. Its sampler is held by
  its properties (unit norm per perturbed leaf, zero on frozen leaves,
  orthogonal to every stored losing row), since the null basis of a
  nonzero memory is up to the SVD's implementation; at an all-zero
  memory both packages' projectors are ``e_0 ... e_{R-1}``.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX package is the reference here
pytest.importorskip("flax")  # its algorithms need it
import jax.numpy as jnp  # noqa: E402

from ultra_pytorch_tpu.algorithms import pdgd as jax_pdgd  # noqa: E402
from ultra_pytorch_tpu.models import base as jax_mbase  # noqa: E402
from ultra_pytorch_tpu.models.dlcm import DLCM as JaxDLCM  # noqa: E402
from ultra_pytorch_tpu.models.dnn import DNN as JaxDNN  # noqa: E402
from ultra_pytorch_tpu.models.gsf import GSF as JaxGSF  # noqa: E402
from ultra_pytorch_tpu.models.linear import Linear as JaxLinear  # noqa: E402
from ultra_pytorch_tpu.models.setrank import (  # noqa: E402
    SetRank as JaxSetRank)
from ultra_pytorch_tpu.run.experiment import (  # noqa: E402
    create_algorithm as jax_create_algorithm)
from ultra_pytorch_tpu.sim import interleave as jax_il  # noqa: E402
from ultra_pytorch_tpu.sim import sampling as jax_sampling  # noqa: E402
from ultra_pytorch_tpu_torch.algorithms import nsgd  # noqa: E402
from ultra_pytorch_tpu_torch.algorithms.pdgd import (  # noqa: E402
    pdgd_pair_weights)
from ultra_pytorch_tpu_torch.models import base  # noqa: E402
from ultra_pytorch_tpu_torch.models.dlcm import DLCM  # noqa: E402
from ultra_pytorch_tpu_torch.models.dnn import DNN  # noqa: E402
from ultra_pytorch_tpu_torch.models.gsf import GSF  # noqa: E402
from ultra_pytorch_tpu_torch.models.linear import Linear  # noqa: E402
from ultra_pytorch_tpu_torch.models.setrank import SetRank  # noqa: E402
from ultra_pytorch_tpu_torch.run.experiment import (  # noqa: E402
    create_algorithm)
from ultra_pytorch_tpu_torch.sim.click_models import (  # noqa: E402
    main as cm_main)

F, B, LC, L = 12, 8, 12, 5
STEPS = 3
TOL = 1e-4
RANKERS = {
    "DNN": (JaxDNN, DNN, "hidden_layer_sizes=[16, 8]"),
    "Linear": (JaxLinear, Linear, ""),
    "GSF": (JaxGSF, GSF, "group_size=3,hidden_layer_sizes=[16, 8]"),
    "DLCM": (JaxDLCM, DLCM, "embed_size=8,hidden_size=6"),
    "SetRank": (JaxSetRank, SetRank,
                "d_model=16,num_heads=4,num_layers=2,diff=8"),
}
KERNELS = pytest.mark.parametrize("kernels", [False, True],
                                  ids=["plain", "kernels"])
DBGD_FAMILY = pytest.mark.parametrize("algo", ["DBGD", "MGD", "NSGD"])


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def click_json(tmp_path_factory):
    out = tmp_path_factory.mktemp("pbm")
    cm_main(["pbm", "0.1", "1.0", "4", "1.0", str(out)])
    return str(out / "pbm_0.1_1.0_4_1.0.json")


# -- the noise utilities ------------------------------------------------------

def _ranker_pair(name):
    jax_cls, cls, hp = RANKERS[name]
    params = jax_cls(hp, F).init(jax.random.PRNGKey(0), F)
    return params, base.params_from_jax(cls(hp, F), params)


def _to_port(arrays, ranker):
    """JAX-layout leaves (with an optional leading axis) -> the port's."""
    return [torch.from_numpy(np.array(
        np.swapaxes(np.asarray(a), -1, -2) if transposed else np.asarray(a)))
        for a, (_, transposed) in zip(arrays, ranker.jax_leaves())]


def _to_jax(tensors, ranker):
    return [(t.transpose(-1, -2) if transposed else t).numpy()
            for t, (_, transposed) in zip(tensors, ranker.jax_leaves())]


@pytest.mark.parametrize("name", list(RANKERS))
def test_noise_spec_equals_jax(name):
    params, ranker = _ranker_pair(name)
    want = [bool(np.asarray(x).all()) for x in
            jax.tree_util.tree_leaves(jax_mbase.noise_spec(params))]
    assert base.noise_spec(ranker) == want
    if name != "DLCM":  # DLCM has no leaf under a perturbed key
        assert any(want)


@pytest.mark.parametrize("name", list(RANKERS))
def test_unit_noise_of_jax_normals_equals_jax(name):
    params, ranker = _ranker_pair(name)
    rng = jax.random.PRNGKey(3)
    leaves = jax.tree_util.tree_leaves(params)
    keys = jax.random.split(rng, len(leaves))
    normals = [jax.random.normal(k, x.shape, x.dtype)
               for k, x in zip(keys, leaves)]
    want = jax.tree_util.tree_leaves(jax_mbase.dbgd_noise_like(rng, params))
    got = _to_jax(base.unit_noise(_to_port(normals, ranker), ranker), ranker)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-6)

    # perturb_ is JAX's perturb.
    noise = base.unit_noise(_to_port(normals, ranker), ranker)
    target = RANKERS[name][1](RANKERS[name][2], F)
    base.perturb_(target, ranker, noise, 0.5)
    want = jax.tree_util.tree_leaves(jax_mbase.perturb(
        params, jax_mbase.dbgd_noise_like(rng, params), 0.5))
    got = _to_jax([t.detach() for t, _ in target.jax_leaves()], ranker)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-6)


def test_dbgd_noise_has_unit_columns():
    """Every output unit's weights (a column of JAX's ``[in, out]``, a
    row of ``nn.Linear``'s ``[out, in]``) and every bias have unit norm,
    for each of the R noises; the LayerNorm's noise is zero."""
    _, ranker = _ranker_pair("DNN")
    noise = base.dbgd_noise_like(torch.Generator().manual_seed(0), ranker,
                                 count=3)
    for n, (t, transposed), noisy in zip(noise, ranker.jax_leaves(),
                                         base.noise_spec(ranker)):
        assert n.shape == (3,) + t.shape
        if not noisy:
            assert (n == 0).all()
            continue
        norms = torch.linalg.vector_norm(n, dim=2 if transposed else 1)
        torch.testing.assert_close(norms, torch.ones_like(norms))


def test_sample_noise_like_is_unit_per_leaf():
    _, ranker = _ranker_pair("SetRank")
    noise = base.sample_noise_like(torch.Generator().manual_seed(1), ranker)
    for n, (t, _) in zip(noise, ranker.jax_leaves()):
        assert n.shape == t.shape
        assert abs(torch.linalg.vector_norm(n).item() - 1.0) < 1e-5


# -- batches and states -------------------------------------------------------

def _batches(seed=0):
    """STEPS online-feed batches: B lists of 3-12 candidates (one with
    none clicked, masked out), clicks on the top L, grades 0-4."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        mask = np.ones((B, LC), np.float32)
        for b in range(B):
            mask[b, rng.integers(3, LC + 1):] = 0.0
        relevance = rng.integers(0, 5, size=(B, LC)).astype(
            np.float32) * mask
        clicks = np.zeros((B, LC), np.float32)
        clicks[:, :L] = (rng.random((B, L)) < 0.4) * mask[:, :L]
        clicks[:, 0] = 1.0
        clicks[-1] = 0.0
        mask[-1] = 0.0
        out.append({
            "features": rng.normal(size=(B, LC, F)).astype(np.float32),
            "labels": clicks, "mask": mask, "relevance": relevance,
            "initial_scores": np.zeros((B, LC), np.float32)})
    return out


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _settings(algo, kernels=False, hparams="", click_json=None):
    ranker = "hidden_layer_sizes=[16, 8]"
    if kernels:
        ranker += ",use_pallas=true"
    hp = [h for h in (hparams,) if h]
    if click_json:
        hp.append(f"click_model_json={click_json}")
    return {"ranking_model": "DNN", "ranking_model_hparams": ranker,
            "learning_algorithm": algo,
            "learning_algorithm_hparams": ",".join(hp),
            "max_candidate_num": LC, "selection_bias_cutoff": L,
            "metrics": ["ndcg"], "metrics_topn": [5]}


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


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _pair(algo, kernels=False, hparams="", click_json=None):
    """(JAX algorithm, JAX state, port algorithm, port state) from the
    same initial state."""
    jax_alg = jax_create_algorithm(_settings(algo, False, hparams,
                                             click_json), F, 4.0)
    state0 = jax_alg.init_state(jax.random.PRNGKey(0), F)
    state0 = state0.replace(params=_perturbed_norms(state0.params))
    alg = create_algorithm(_settings(algo, kernels, hparams, click_json), F,
                           4.0, device="cpu")
    state = alg.load_state_leaves(
        alg.init_state(torch.Generator().manual_seed(0)), _leaves(state0))
    return jax_alg, state0, alg, state


def _assert_close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-12)
    assert float(np.abs(got - want).max()) <= TOL * scale, what


# -- PDGD ---------------------------------------------------------------------

@pytest.mark.parametrize("tau", [1.0, 0.5])
def test_pdgd_pair_weights_equal_jax(tau):
    for batch in _batches(seed=4):
        rng = np.random.default_rng(int(tau * 10))
        scores = rng.normal(size=(B, LC)).astype(np.float32)
        want = jax_pdgd.pdgd_pair_weights(
            jnp.asarray(scores), jnp.asarray(batch["labels"]),
            jnp.asarray(batch["mask"]), L, tau)
        got = pdgd_pair_weights(torch.from_numpy(scores),
                                torch.from_numpy(batch["labels"]),
                                torch.from_numpy(batch["mask"]), L, tau)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5)


@KERNELS
def test_pdgd_first_step_gradients_equal_jax(kernels):
    jax_alg, state0, alg, state = _pair("PDGD", kernels)
    captured = []
    apply_updates = jax_alg.apply_updates

    def capture(opt, params, opt_state, grads):
        captured.append(grads)
        return apply_updates(opt, params, opt_state, grads)

    jax_alg.apply_updates = capture
    batch = _batches()[0]
    _, want = jax_alg.train_step(state0, batch, jax.random.PRNGKey(0))
    out = alg.losses(state, _torch_batch(batch))
    grads = torch.autograd.grad(out[0], alg.trainable(state))
    for key, got in alg.metrics(out).items():
        np.testing.assert_allclose(got.item(), float(want[key]),
                                   rtol=1e-5, atol=1e-6, err_msg=key)
    for g, w in zip(_to_jax(grads, state.params), _leaves(captured[0])):
        _assert_close(g, w, "gradient")


@KERNELS
def test_pdgd_three_steps_equal_jax(kernels):
    jax_alg, jax_state, alg, state = _pair("PDGD", kernels)
    for i, batch in enumerate(_batches()):
        jax_state, want = jax_alg.train_step(jax_state, batch,
                                             jax.random.PRNGKey(i))
        state, got = alg.train_step(state, _torch_batch(batch))
        assert sorted(got) == sorted(want)
        for key in want:
            np.testing.assert_allclose(got[key].item(), float(want[key]),
                                       rtol=1e-4, atol=1e-6, err_msg=key)
    for a, b in zip(alg.state_leaves(state), _leaves(jax_state)):
        _assert_close(a, b, "state leaf")


# -- DBGD, MGD, NSGD ----------------------------------------------------------

def _noises(jax_alg, state0, port_ranker, seed=7):
    """R JAX noise trees and the same noises in the port's layout (one
    tensor a leaf, a leading R axis)."""
    keys = jax.random.split(jax.random.PRNGKey(seed), jax_alg.ranker_num)
    trees = [jax_mbase.dbgd_noise_like(k, state0.params) for k in keys]
    stacked = [np.stack(leaves) for leaves in
               zip(*[_leaves(t) for t in trees])]
    return trees, _to_port(stacked, port_ranker)


def _winners(n_rankers, seed=8):
    """Click shares [B, R + 1]; rankers 2 and 4 (of MGD / NSGD) never
    win, so NSGD's memory keeps their noises."""
    rng = np.random.default_rng(seed)
    w = rng.random((B, n_rankers)).astype(np.float32)
    if n_rankers > 2:
        w[:, 2] = 0.0
        w[:, 4] = 0.0
    return w / w.sum(axis=1, keepdims=True)


def _patched(jax_alg, alg, trees, noises, winners, clicks):
    jax_alg._sample_noises_with_state = lambda rng, state: trees
    jax_alg._interleave_winners = lambda rng, scores, batch: (
        jnp.asarray(winners), jnp.asarray(clicks), None)
    alg.sample_noises = lambda state, generator: noises
    alg.interleave_winners = lambda scores, batch, generator: (
        torch.from_numpy(winners), torch.from_numpy(clicks), None)


@DBGD_FAMILY
def test_step_given_noises_and_winners_equals_jax(algo, click_json):
    jax_alg, state0, alg, state = _pair(algo, click_json=click_json)
    trees, noises = _noises(jax_alg, state0, state.params)
    winners = _winners(alg.ranker_num + 1)
    batch = _batches()[0]
    clicks = batch["labels"][:, :L]
    _patched(jax_alg, alg, trees, noises, winners, clicks)
    jax_state, want = jax_alg.train_step(state0, batch, jax.random.PRNGKey(0))
    state, got = alg.train_step(state, _torch_batch(batch),
                                torch.Generator().manual_seed(0))
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key].item(), float(want[key]),
                                   rtol=0, atol=1e-6, err_msg=key)
    mine, theirs = alg.state_leaves(state), _leaves(jax_state)
    assert len(mine) == len(theirs)
    for a, b in zip(mine, theirs):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    if algo == "NSGD":
        # The memory holds the losers' noises (rankers 2 and 4) exactly.
        for a, b in zip(_leaves(state.aux), _leaves(jax_state.aux)):
            np.testing.assert_array_equal(a.numpy() if torch.is_tensor(a)
                                          else a, b)


@pytest.mark.parametrize("source", ["perturb", "fresh"])
def test_candidate_scores(click_json, source):
    """Under ``perturb`` each candidate's scores equal JAX's of ``params +
    lr * noise`` (within 1e-5); under ``fresh`` the candidates draw a new
    ranker each and the current ranker's weights do not move."""
    hp = f"candidate_source={source}"
    jax_alg, state0, alg, state = _pair("MGD", hparams=hp,
                                        click_json=click_json)
    trees, noises = _noises(jax_alg, state0, state.params)
    batch = _batches()[0]
    before = [t.clone() for t, _ in state.params.jax_leaves()]
    got = alg.candidate_scores(state, _torch_batch(batch), noises,
                               torch.Generator().manual_seed(0))
    assert len(got) == alg.ranker_num + 1
    for t, b in zip([t for t, _ in state.params.jax_leaves()], before):
        assert torch.equal(t, b)
    want = [jax_alg.score_with_params(state0.params, batch,
                                      is_training=False)]
    want += [jax_alg.score_with_params(
        jax_mbase.perturb(state0.params, tree, 0.5), batch,
        is_training=False) for tree in trees]
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-5, atol=1e-5)
    for g, w in zip(got[1:], want[1:]):
        if source == "perturb":
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                       atol=1e-5)
        else:
            assert np.isfinite(g.numpy()).all()
            assert not np.allclose(g.numpy(), np.asarray(w), atol=1e-3)


@pytest.mark.parametrize("n_rankers", [2, 5])
def test_draft_winners_equal_jax_given_its_draws(click_json, n_rankers):
    """JAX's ``_interleave_winners``, and the port's winner inference given
    JAX's draft and click uniforms (from its key splits)."""
    algo = "DBGD" if n_rankers == 2 else "MGD"
    jax_alg, _, alg, _ = _pair(algo, click_json=click_json)
    batch = _batches()[1]
    rng = np.random.default_rng(n_rankers)
    scores = [jnp.asarray(rng.normal(size=(B, LC)).astype(np.float32))
              for _ in range(n_rankers)]
    key = jax.random.PRNGKey(11)
    want = jax_alg._interleave_winners(key, scores, batch)
    k_rank, k_draft, k_click = jax.random.split(key, 3)
    rankings = jnp.stack([
        jax_sampling.plackett_luce_sample(k, s, batch["mask"], tau=1.0)
        for s, k in zip(scores, jax.random.split(k_rank, n_rankers))],
        axis=1)
    multileaved, teams = jax_il.team_draft_interleave(k_draft, rankings)
    keys = jax.random.split(jax.random.fold_in(k_click, 3),
                            alg.CLICK_RESAMPLE_ROUNDS)
    u = np.stack([np.asarray(jax.random.uniform(k, (B, L)))
                  for k in [k_click] + list(keys)])
    got = alg.draft_winners(
        torch.from_numpy(np.array(multileaved[:, :L])).long(),
        torch.from_numpy(np.array(teams[:, :L])).long(),
        _torch_batch(batch), torch.from_numpy(u), n_rankers)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0,
                               atol=1e-7)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].item(), float(want[2]), rtol=0,
                               atol=1e-6)


def test_ndcg_winners_equal_jax(click_json):
    """Four candidates: three with other scores (nDCGs clearly apart from
    the current ranker's) and one with the same scores (an exact tie)."""
    jax_alg, _, alg, _ = _pair("MGD", hparams="need_interleave=false",
                               click_json=click_json)
    batch = _batches()[2]
    rng = np.random.default_rng(5)
    first = rng.normal(size=(B, LC)).astype(np.float32)
    scores = [first] + [rng.normal(size=(B, LC)).astype(np.float32)
                        for _ in range(3)] + [first.copy()]
    want = jax_alg._ndcg_winners([jnp.asarray(s) for s in scores], batch)
    got = alg.ndcg_winners([torch.from_numpy(s) for s in scores],
                           _torch_batch(batch))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-7)
    assert got[-1] == 0


def test_nsgd_aux_update_equals_jax(click_json):
    jax_alg, state0, alg, state = _pair("NSGD", click_json=click_json)
    trees, noises = _noises(jax_alg, state0, state.params)
    totals = np.array([1.5, 0.0, 2.0, 0.0, 0.25], np.float32)
    want = jax_alg._update_aux(state0, trees, jnp.asarray(totals))
    got = alg.updated_aux(state, noises, torch.from_numpy(totals))
    for a, b in zip(got["bad_noise"], _leaves(want["bad_noise"])):
        np.testing.assert_array_equal(a.numpy(), b)


def _null_projector(bad):
    """vh^T diag(s <= tol) vh of a memory [R, D] (torch) as numpy."""
    _, s, vh = torch.linalg.svd(bad, full_matrices=False)
    null = vh * (s <= nsgd.SV_TOL)[:, None]
    return (null.t() @ null).numpy()


def test_nsgd_null_basis_at_zero_memory_equals_jax():
    bad = np.zeros((4, 64), np.float32)
    _, s, vh = jnp.linalg.svd(jnp.asarray(bad), full_matrices=False)
    null = np.asarray(vh) * (np.asarray(s) <= nsgd.SV_TOL)[:, None]
    want = null.T @ null
    np.testing.assert_allclose(_null_projector(torch.from_numpy(bad)), want,
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.diag(want)[:4], np.ones(4))


def test_nsgd_samples_in_the_null_space(click_json):
    """A memory of two losing rows (rows 0 and 2) on every perturbed
    leaf: each sampled noise has unit norm on each perturbed leaf, is zero
    on the frozen ones, and is orthogonal to both stored rows (the
    one-element output bias is a random sign, as in JAX, and has no null
    space to keep)."""
    _, _, alg, state = _pair("NSGD", click_json=click_json)
    gen = torch.Generator().manual_seed(0)
    for bad, noisy in zip(state.aux["bad_noise"],
                          base.noise_spec(state.params)):
        if noisy and bad[0].numel() > 1:
            rows = torch.randn(bad.shape, generator=gen)
            rows[1] = 0.0
            rows[3] = 0.0
            bad.copy_(rows)
    noises = alg.sample_noises(state, gen)
    for n, (t, transposed), noisy, bad in zip(
            noises, state.params.jax_leaves(),
            base.noise_spec(state.params), state.aux["bad_noise"]):
        assert n.shape == (alg.ranker_num,) + t.shape
        if not noisy:
            assert (n == 0).all()
            continue
        flat = (n.transpose(-1, -2) if transposed else n).reshape(
            alg.ranker_num, -1)
        torch.testing.assert_close(flat.norm(dim=1),
                                   torch.ones(alg.ranker_num))
        if bad[0].numel() > 1:
            losers = bad.reshape(alg.ranker_num, -1)[[0, 2]]
            losers = losers / losers.norm(dim=1, keepdim=True)
            assert (flat @ losers.t()).abs().max().item() < 1e-5
