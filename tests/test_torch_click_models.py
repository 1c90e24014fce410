"""The UBM and cascade click models of the port against the JAX package's.

Given JAX's own uniforms (``jax.random.uniform`` of the key its
``sample_clicks`` draws with), the port's ``clicks_from_uniforms`` gives
JAX's clicks exactly, and its examination and click probabilities to
the last bit of float32 ``pow``: at eta 0.5, 1 and 2, on masked lists,
and at L = 14, where UBM reaches its rank >= 10 edge case. UBM is also
held statistically to the sequential numpy oracle of
``tests/test_click_models.py`` (the reference's semantics, written
independently). Propensity weights agree within 1e-6, and the JSONs
(UBM's ragged rows) are equal: exactly at eta 1, to the last bit of
``pow`` at eta 0.5. A feed asked for K5 on a click model other than PBM
raises at construction.
"""

import json
import types

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX package is the reference here
pytest.importorskip("flax")  # its click models need it

from ultra_pytorch_tpu.sim import click_models as jax_cm  # noqa: E402
from ultra_pytorch_tpu_torch.data.dataset import RankingDataset  # noqa: E402
from ultra_pytorch_tpu_torch.input_layer import feeds  # noqa: E402
from ultra_pytorch_tpu_torch.sim import click_models as cm  # noqa: E402

MODELS = pytest.mark.parametrize("name", ["ubm", "cascade", "pbm"])
ETAS = pytest.mark.parametrize("eta", [0.5, 1.0, 2.0])


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _labels(seed, shape, masked=True):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 5, size=shape).astype(np.float32)
    mask = np.ones(shape, np.float32)
    if masked:
        mask = (rng.random(shape) < 0.85).astype(np.float32)
        mask[..., 0, :] = 1.0
    return labels, mask


@MODELS
@ETAS
@pytest.mark.parametrize("L", [10, 14])
@pytest.mark.parametrize("masked", [False, True], ids=["full", "masked"])
def test_clicks_from_uniforms_equal_jax(name, eta, L, masked):
    labels, mask = _labels(L, (256, L), masked)
    key = jax.random.PRNGKey(int(10 * eta) + L)
    jax_model = jax_cm.make_click_model(name, 0.1, 1.0, 4, eta)
    want = jax_cm.sample_clicks(jax_model, key, labels,
                                mask if masked else None)
    u = np.array(jax.random.uniform(key, labels.shape))
    got = cm.clicks_from_uniforms(
        cm.make_click_model(name, 0.1, 1.0, 4, eta), torch.from_numpy(labels),
        torch.from_numpy(u), torch.from_numpy(mask) if masked else None)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    # exam^eta: XLA's and torch's float32 pow may differ in the last bit.
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-7,
                                   atol=0)
    assert got[0].sum() > 0


@pytest.mark.parametrize("name", ["ubm", "cascade"])
def test_per_step_eta_matches_one_eta_at_a_time(name):
    labels, mask = _labels(3, (3, 40, 12))
    u = torch.rand(labels.shape, generator=torch.Generator().manual_seed(3))
    model = cm.make_click_model(name)
    etas = torch.tensor([1.0, 1.5, 2.0])
    batched = cm.clicks_from_uniforms(model.replace(eta=etas),
                                      torch.from_numpy(labels), u,
                                      torch.from_numpy(mask))
    for i, eta in enumerate(etas):
        one = cm.clicks_from_uniforms(model.replace(eta=eta),
                                      torch.from_numpy(labels[i]), u[i],
                                      torch.from_numpy(mask[i]))
        for a, b in zip(batched, one):
            torch.testing.assert_close(a[i], b, rtol=0, atol=0)


def test_ubm_sampler_matches_the_sequential_numpy_oracle():
    """The port's UBM vs an independent sequential numpy implementation
    (exam = table[rank, rank - last_click - 1], last_click from -1):
    per-position rates and click-conditional rates."""
    model = cm.make_click_model("ubm", 0.1, 1.0, 4, 1.0)
    table = model.exam_prob.double().numpy()
    click_p = model.click_prob.double().numpy()
    rng = np.random.default_rng(7)
    N, L = 40000, 10
    labels = rng.integers(0, 5, size=(N, L))
    oracle = np.zeros((N, L), np.float32)
    for i in range(N):
        last = -1
        for r in range(L):
            if rng.random() < table[r, r - last - 1] * click_p[labels[i, r]]:
                oracle[i, r] = 1.0
                last = r
    ours, _, _ = cm.sample_clicks(model, torch.Generator().manual_seed(11),
                                  torch.from_numpy(labels).float())
    ours = ours.numpy()
    np.testing.assert_allclose(ours.mean(0), oracle.mean(0), atol=0.012)
    for p in (1, 4, 8):
        o = oracle[oracle[:, p - 1] > 0][:, p].mean()
        u = ours[ours[:, p - 1] > 0][:, p].mean()
        assert abs(o - u) < 0.025, (p, o, u)


def test_cascade_clicks_at_most_once_a_list():
    labels, mask = _labels(4, (5000, 10))
    model = cm.make_click_model("cascade", 0.1, 1.0, 4, 1.0)
    clicks, exam, _ = cm.sample_clicks(model, torch.Generator().manual_seed(2),
                                       torch.from_numpy(labels),
                                       torch.from_numpy(mask))
    per_list = clicks.sum(dim=1)
    assert per_list.max() == 1 and per_list.mean() > 0.5
    # Positions after the first click are not examined.
    first = torch.argmax(clicks, dim=1)
    after = torch.arange(10)[None, :] > first[:, None]
    assert not (exam * after * (per_list[:, None] > 0)).any()


@pytest.mark.parametrize("name", ["ubm", "cascade"])
@ETAS
@pytest.mark.parametrize("L", [10, 14])
@pytest.mark.parametrize("use_non_clicked", [False, True])
def test_propensity_weights_match_jax(name, eta, L, use_non_clicked):
    rng = np.random.default_rng(L)
    clicks = (rng.random((64, L)) < 0.3).astype(np.float32)
    clicks[:4] = 0.0   # lists without a click
    got = cm.propensity_weights(cm.make_click_model(name, 0.1, 1.0, 4, eta),
                                torch.from_numpy(clicks), use_non_clicked)
    want = jax_cm.propensity_weights(
        jax_cm.make_click_model(name, 0.1, 1.0, 4, eta), clicks,
        use_non_clicked)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("name", ["ubm", "cascade"])
@pytest.mark.parametrize("eta", [0.5, 1.0])
def test_json_matches_jax(tmp_path, name, eta):
    """``model_to_json`` (UBM's rows ragged), the numpy JSON, the CLI's
    file and the loader, which rebuilds the canonical table whatever the
    JSON's ``exam_prob`` says."""
    ours = cm.model_to_json(cm.make_click_model(name, 0.1, 1.0, 4, eta))
    theirs = jax_cm.model_to_json(jax_cm.make_click_model(name, 0.1, 1.0, 4,
                                                          eta))
    assert ours.keys() == theirs.keys()
    assert {k: v for k, v in ours.items() if k != "exam_prob"} == {
        k: v for k, v in theirs.items() if k != "exam_prob"}
    rows = ours["exam_prob"] if name == "ubm" else [ours["exam_prob"]]
    want_rows = (theirs["exam_prob"] if name == "ubm"
                 else [theirs["exam_prob"]])
    assert [len(r) for r in rows] == [len(r) for r in want_rows]
    for a, b in zip(rows, want_rows):
        if eta == 1.0:
            assert a == b
        np.testing.assert_allclose(a, b, rtol=2e-7, atol=0)
    assert cm.click_model_json_numpy(name, 0.1, 1.0, 4, eta) == \
        jax_cm.click_model_json_numpy(name, 0.1, 1.0, 4, eta)
    cm.main([name, "0.1", "1.0", "4", str(eta), str(tmp_path)])
    written = tmp_path / f"{name}_0.1_1.0_4_{eta}.json"
    desc = json.loads(written.read_text())
    desc["exam_prob"] = "ignored"
    loaded = cm.load_model_from_json(desc)
    want = jax_cm.load_model_from_json(desc)
    assert loaded.model_name == want.model_name
    for a, b in ((loaded.exam_prob, want.exam_prob),
                 (loaded.click_prob, want.click_prob)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert float(loaded.eta) == eta


@pytest.mark.parametrize("name", ["ubm", "cascade"])
@pytest.mark.parametrize("check_validation", [True, False])
def test_k5_with_another_click_model_raises_at_feed_construction(
        tmp_path, name, check_validation):
    """The name is the test's history: it asserted a raise that the JAX
    feed never had, and now asserts the opposite. ``use_pallas_click=true``
    selects K5 for PBM only. A UBM or cascade feed with it is built, as
    the JAX feed is (its kernel branch is PBM's alone), also when the
    click-rate estimate (the first sampling) is skipped, and samples its
    own model: the same draws as the feed without the flag under one
    generator."""
    cm.main([name, "0.1", "1.0", "4", "1.0", str(tmp_path)])
    path = tmp_path / f"{name}_0.1_1.0_4_1.0.json"
    rng = np.random.default_rng(0)
    Q, L = 20, 10
    ds = RankingDataset(
        features=rng.normal(size=(Q * L, 4)).astype(np.float32),
        initial_list=np.arange(Q * L).reshape(Q, L),
        labels=rng.integers(0, 5, size=(Q, L)).astype(np.float32),
        qids=[str(q) for q in range(Q)],
        dids=[str(d) for d in range(Q * L)], feature_size=4,
        rank_list_size=L, max_label=4.0).to_device("cpu")
    alg = types.SimpleNamespace(rank_list_size=L)
    plans = []   # the window plan and the pool size, flag on and off
    for flag in (",use_pallas_click=true", ""):
        feed = feeds.ClickSimulationFeed(
            alg, 8, f"click_model_json={path}{flag}", ds,
            check_validation=check_validation)
        plans.append(feed.train_batch_plan(
            torch.Generator().manual_seed(0), 0, 3)
            + (feed._pool_size(8),))
    for a, b in zip(*plans):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
    qs, clicks, valid, _ = plans[0]
    assert clicks.shape == (3, 8, L)
    if name == "cascade":
        assert clicks.sum(-1).max() <= 1
