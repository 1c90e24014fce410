"""The port's propensity estimators (over PBM, UBM and cascade), the
click models' propensity weights and the ranking samplers against the
JAX package's, and the estimator CLI
(``python -m ultra_pytorch_tpu_torch.sim.propensity --device cpu``).

Deterministic pieces (the Basic and Oracle weights, ``rerank``,
``deterministic_rank``) must equal JAX's; random ones (the randomized
estimate, Plackett-Luce draws) are held statistically, since Philox and
threefry streams never match.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX package is the reference here
pytest.importorskip("flax")  # its click models need it

from ultra_pytorch_tpu.sim import click_models as jax_cm  # noqa: E402
from ultra_pytorch_tpu.sim import propensity as jax_prop  # noqa: E402
from ultra_pytorch_tpu.sim import sampling as jax_sampling  # noqa: E402
from ultra_pytorch_tpu_torch.data.dataset import read_data  # noqa: E402
from ultra_pytorch_tpu_torch.sim import click_models as cm  # noqa: E402
from ultra_pytorch_tpu_torch.sim import propensity as prop  # noqa: E402
from ultra_pytorch_tpu_torch.sim import sampling  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _clicks(B=16, L=12, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.random((B, L)) < 0.4).astype(np.float32)


@pytest.mark.parametrize("use_non_clicked", [False, True])
def test_basic_weights_equal_jax(use_non_clicked):
    """Positions beyond the table take its last entry; clicked-only
    unless use_non_clicked_data."""
    table = [1.0, 1.5, 2.25, 4.0]
    clicks = _clicks()
    got = prop.BasicPropensityEstimator(ipw_list=table).weights(
        torch.from_numpy(clicks), use_non_clicked)
    want = jax_prop.BasicPropensityEstimator(ipw_list=table).weights(
        clicks, use_non_clicked)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[:, 4:].unique().tolist() in ([0.0, 4.0], [4.0])


def test_basic_weights_follow_the_clicks_device_and_a_new_table():
    est = prop.BasicPropensityEstimator(ipw_list=[1.0, 2.0])
    clicks = torch.ones(2, 3)
    assert est.weights(clicks).tolist() == [[1.0, 2.0, 2.0]] * 2
    est.IPW_list = [3.0]
    assert est.weights(clicks).tolist() == [[3.0, 3.0, 3.0]] * 2


@pytest.mark.parametrize("eta", [1.0, 0.5, 2.0])
@pytest.mark.parametrize("use_non_clicked", [False, True])
def test_oracle_pbm_weights_equal_jax_exactly(tmp_path, eta,
                                              use_non_clicked):
    desc = cm.click_model_json_numpy("pbm", 0.1, 1.0, 4, eta)
    path = tmp_path / "oracle.json"
    path.write_text(json.dumps({"click_model": desc, "IPW_list": [1.0]}))
    clicks = _clicks(L=13)
    got = prop.OraclePropensityEstimator(file_name=str(path)).weights(
        torch.from_numpy(clicks), use_non_clicked)
    want = jax_prop.OraclePropensityEstimator(file_name=str(path)).weights(
        clicks, use_non_clicked)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_propensity_weights_of_other_click_models_raise():
    """UBM's weights (ported, no longer raising) equal JAX's: ``1 / exam``
    given the clicks before each position."""
    clicks = _clicks(L=12)
    for use_non_clicked in (False, True):
        got = cm.propensity_weights(cm.make_click_model("ubm"),
                                    torch.from_numpy(clicks),
                                    use_non_clicked)
        want = jax_cm.propensity_weights(jax_cm.make_click_model("ubm"),
                                         clicks, use_non_clicked)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["ubm", "cascade"])
def test_oracle_weights_of_ubm_and_cascade_equal_jax(tmp_path, name):
    """The Oracle estimator reads a UBM or cascade model from its JSON and
    weights click patterns as JAX's does (UBM through its sequential
    walk), within 1e-6."""
    desc = cm.click_model_json_numpy(name, 0.1, 1.0, 4, 1.0)
    path = tmp_path / "oracle.json"
    path.write_text(json.dumps({"click_model": desc, "IPW_list": [1.0]}))
    clicks = _clicks(L=13)
    for use_non_clicked in (False, True):
        got = prop.OraclePropensityEstimator(file_name=str(path)).weights(
            torch.from_numpy(clicks), use_non_clicked)
        want = jax_prop.OraclePropensityEstimator(
            file_name=str(path)).weights(clicks, use_non_clicked)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["ubm", "cascade"])
def test_randomized_estimates_of_ubm_and_cascade_match_jax(name):
    """200k randomized sessions through each package's sampler: the two
    estimates agree within 8% at every position (their spread at this
    count is under 3%)."""
    labels, mask = _pbm_labels()
    est = prop.RandomizedPropensityEstimator()
    est.estimate_from_model(cm.make_click_model(name), labels, mask,
                            sessions=200_000, batch=1 << 15, device="cpu")
    jax_est = jax_prop.RandomizedPropensityEstimator()
    jax_est.estimate_from_model(jax_cm.make_click_model(name), labels, mask,
                                sessions=200_000, batch=1 << 15)
    assert est.click_model.model_name == jax_est.click_model.model_name
    assert abs(est.IPW_list[0] - 1.0) < 1e-6   # the 10e-6 epsilon
    np.testing.assert_allclose(est.IPW_list, jax_est.IPW_list, rtol=0.08)


def _pbm_labels(Q=50, L=6):
    rng = np.random.default_rng(0)
    return (rng.integers(0, 5, size=(Q, L)).astype(np.float32),
            np.ones((Q, L), np.float32))


def test_randomized_estimator_recovers_pbm_and_its_json_crosses(tmp_path):
    """400k sessions (the JAX package's own test) give exam[0] / exam
    within rtol 0.1; the JSON either package writes, the other reads."""
    model = cm.make_click_model("pbm", 0.1, 1.0, 4, 1.0)
    labels, mask = _pbm_labels()
    est = prop.RandomizedPropensityEstimator()
    est.estimate_from_model(model, labels, mask, sessions=400_000,
                            batch=1 << 15, device="cpu")
    exam = cm.PBM_EXAM_PROB[:6]
    np.testing.assert_allclose(est.IPW_list, exam[0] / exam, rtol=0.1)

    mine = str(tmp_path / "port.json")
    est.save(mine)
    theirs = jax_prop.BasicPropensityEstimator(file_name=mine)
    np.testing.assert_array_equal(theirs.IPW_list, est.IPW_list)
    assert theirs.click_model.model_name == "position_biased_model"
    np.testing.assert_array_equal(np.asarray(theirs.click_model.exam_prob),
                                  model.exam_prob.numpy())

    jax_est = jax_prop.BasicPropensityEstimator(ipw_list=[1.0, 1.25, 2.5])
    jax_est.click_model = jax_cm.make_click_model("pbm", 0.1, 1.0, 4, 0.5)
    path = str(tmp_path / "jax.json")
    jax_est.save(path)
    back = prop.BasicPropensityEstimator(file_name=path)
    assert back.IPW_list == [1.0, 1.25, 2.5]
    assert back.click_model.eta.item() == 0.5
    np.testing.assert_array_equal(back.click_model.click_prob.numpy(),
                                  np.asarray(jax_est.click_model.click_prob))


def test_estimator_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    labels, mask = _pbm_labels()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prop.RandomizedPropensityEstimator().estimate_from_model(
            cm.make_click_model("pbm"), labels, mask, sessions=10)
    assert prop.parse_args(["a", "b", "c"]).device == "cuda"


def test_randomized_estimate_counts_lists_by_length():
    """Lists of several lengths, one without documents: each length's
    clicks land in its own row, so position 0's weight is 1 and positions
    past the shortest lists still get weights."""
    rng = np.random.default_rng(1)
    Q, L = 40, 8
    lengths = rng.integers(0, L + 1, size=Q)
    lengths[:4] = (0, 2, 5, L)
    mask = (np.arange(L)[None, :] < lengths[:, None]).astype(np.float32)
    labels = np.full((Q, L), 4.0, np.float32) * mask
    est = prop.RandomizedPropensityEstimator()
    est.estimate_from_model(cm.make_click_model("pbm"), labels, mask,
                            sessions=200_000, batch=1 << 14, device="cpu")
    exam = cm.PBM_EXAM_PROB[:L]
    np.testing.assert_allclose(est.IPW_list, exam[0] / exam, rtol=0.1)


def test_plackett_luce_sample_is_a_permutation_with_pads_last():
    gen = torch.Generator().manual_seed(0)
    B, L = 64, 300
    scores = torch.randn(B, L, generator=gen)
    mask = (torch.rand(B, L, generator=gen) < 0.1).float()
    ranks = sampling.plackett_luce_sample(gen, scores, mask, tau=1.0)
    assert ranks.dtype == torch.int64
    assert torch.equal(ranks.sort(dim=1).values,
                       torch.arange(L).expand(B, L))
    for b in range(B):
        n = int(mask[b].sum())
        assert set(ranks[b, :n].tolist()) == set(
            torch.nonzero(mask[b]).flatten().tolist())
        # -1e9 - j ties in float32 for j < 64: only a stable sort keeps
        # the pads in index order.
        pads = ranks[b, n:]
        assert torch.equal(pads, pads.sort().values)


def test_plackett_luce_first_place_frequencies():
    """P(first = i) = softmax(tau * s)_i, within 4 sigma."""
    n, tau = 40_000, 0.7
    s = torch.tensor([2.0, 1.0, 0.0, -1.0])
    gen = torch.Generator().manual_seed(1)
    ranks = sampling.plackett_luce_sample(gen, s.expand(n, 4), tau=tau)
    freq = torch.bincount(ranks[:, 0], minlength=4).double() / n
    p = torch.softmax(tau * s.double(), 0)
    z = ((freq - p).abs() / (p * (1 - p) / n).sqrt()).max().item()
    assert z < 4.0


def test_rerank_and_deterministic_rank_equal_jax():
    rng = np.random.default_rng(2)
    scores = rng.normal(size=(8, 11)).astype(np.float32)
    scores[:, 3] = scores[:, 5]   # ties keep index order
    mask = (rng.random((8, 11)) < 0.7).astype(np.float32)
    values = rng.normal(size=(8, 11)).astype(np.float32)
    for m in (None, mask):
        got = sampling.deterministic_rank(
            torch.from_numpy(scores), None if m is None
            else torch.from_numpy(m))
        want = jax_sampling.deterministic_rank(scores, m)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(
            sampling.rerank(torch.from_numpy(values), got).numpy(),
            np.asarray(jax_sampling.rerank(values, want)))


def test_cli_estimates_from_the_train_split(tmp_path):
    click_json = tmp_path / "pbm_0.1_1.0_4_1.0.json"
    click_json.write_text(json.dumps(
        cm.click_model_json_numpy("pbm", 0.1, 1.0, 4, 1.0)))
    out_dir = tmp_path / "out"
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "ultra_pytorch_tpu_torch.sim.propensity",
         str(click_json), os.path.join(REPO, "tests", "data"),
         str(out_dir), "20000", "--device", "cpu"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    out = out_dir / "randomized_pbm_0.1_1.0_4_1.0.json"
    assert proc.stdout.strip().splitlines()[-1] == str(out)
    est = jax_prop.RandomizedPropensityEstimator(file_name=str(out))
    longest = read_data(os.path.join(REPO, "tests", "data"),
                        "train").rank_list_size
    assert len(est.IPW_list) == longest == 9
    assert all(np.isfinite(est.IPW_list)) and min(est.IPW_list) > 0
    exam = cm.PBM_EXAM_PROB[:5]
    np.testing.assert_allclose(est.IPW_list[:5], exam[0] / exam, rtol=0.15)
    assert est.click_model.model_name == "position_biased_model"
