"""The port's feeds against the JAX package's on the same dataset.

Gathers and pool sizes are compared exactly; the click-simulation draws
come from different generators in the two packages, so their statistics
(click rate per position, share of clicked lists, masking of lists that
were never clicked) are compared within 4 sigma.
"""

import types

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX package is the reference here
pytest.importorskip("flax")  # its click models and algorithms need it
import jax.numpy as jnp  # noqa: E402

from ultra_pytorch_tpu.data.dataset import RankingDataset as JaxDataset
from ultra_pytorch_tpu.input_layer import feeds as jax_feeds
from ultra_pytorch_tpu.sim.click_models import main as jax_cm_main
from ultra_pytorch_tpu_torch.data.dataset import RankingDataset
from ultra_pytorch_tpu_torch.input_layer import feeds
from ultra_pytorch_tpu_torch.utils import spans

Q, L, F = 300, 12, 6
CUT = 10


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def click_json(tmp_path_factory):
    out = tmp_path_factory.mktemp("pbm")
    jax_cm_main(["pbm", "0.1", "1.0", "4", "1.0", str(out)])
    return str(out / "pbm_0.1_1.0_4_1.0.json")


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(2, L + 1, size=Q)
    d = int(lengths.sum())
    initial_list = -np.ones((Q, L), np.int64)
    labels = np.zeros((Q, L), np.float32)
    start = 0
    for q, n in enumerate(lengths):
        initial_list[q, :n] = np.arange(start, start + n)
        labels[q, :n] = rng.integers(0, 5, size=n)
        start += n
    return dict(features=rng.normal(size=(d, F)).astype(np.float32),
                initial_list=initial_list, labels=labels,
                qids=[str(q) for q in range(Q)],
                dids=[f"d{i}" for i in range(d)], feature_size=F,
                rank_list_size=L, max_label=4.0)


def _algorithm():
    return types.SimpleNamespace(rank_list_size=CUT)


def _pair(click_json, hparams="", cls="ClickSimulationFeed", batch=16):
    arrs = _arrays()
    if cls == "ClickSimulationFeed":
        hparams = f"click_model_json={click_json},{hparams}"
    jax_feed = getattr(jax_feeds, cls)(_algorithm(), batch, hparams,
                                       JaxDataset(**arrs).to_device())
    feed = getattr(feeds, cls)(_algorithm(), batch, hparams,
                               RankingDataset(**arrs).to_device("cpu"))
    return jax_feed, feed


def test_gather_equals_jax(click_json):
    jax_feed, feed = _pair(click_json)
    qs = np.array([0, 5, 299, 5, 17])
    for list_size in (None, CUT):
        want = jax_feed.dataset.gather(jnp.asarray(qs), list_size=list_size)
        got = feed.dataset.gather(torch.from_numpy(qs), list_size=list_size)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("hparams", ["", "resample_overdraw=1.7",
                                     "resample_overdraw=0.5"])
def test_pool_size_equals_jax(click_json, hparams):
    jax_feed, feed = _pair(click_json, hparams)
    for p_lo in (None, 0.02, 0.3, 0.9):
        jax_feed._p_click_lo = feed._p_click_lo = p_lo
        for batch in (1, 16, 256):
            assert feed._pool_size(batch) == jax_feed._pool_size(batch)


def test_click_rate_estimate_agrees_with_jax(click_json):
    jax_feed, feed = _pair(click_json)
    n = min(4096, Q)
    p = jax_feed._p_click_lo
    assert feed._p_click_lo is not None
    assert abs(feed._p_click_lo - p) <= 4 * np.sqrt(2 * p * (1 - p) / n)


def _jax_plan(jax_feed, n):
    state = types.SimpleNamespace(step=jnp.int32(0))
    qs, clicks, valid = jax_feed.train_batch_plan(
        jax.random.PRNGKey(0), state, jax_feed.dataset, n)
    return np.asarray(qs), np.asarray(clicks), np.asarray(valid)


@pytest.mark.parametrize("hparams", ["", "resample_strategy=rounds",
                                     "use_pallas_click=true",
                                     "resample_overdraw=1"])
def test_plan_statistics_match_jax(click_json, hparams):
    jax_feed, feed = _pair(click_json, hparams)
    n = 150
    want_qs, want_clicks, want_valid = _jax_plan(jax_feed, n)
    before = spans.counters()["launches.K5"]
    qs, clicks, valid = feed.train_batch_plan(
        torch.Generator().manual_seed(0), 0, n)
    assert spans.counters()["launches.K5"] == before  # CPU: the plain version
    assert qs.shape == want_qs.shape and clicks.shape == want_clicks.shape
    assert valid.shape == want_valid.shape
    qs, clicks, valid = qs.numpy(), clicks.numpy(), valid.numpy()
    assert qs.min() >= 0 and qs.max() < Q
    mask = feed.dataset.mask.numpy()[qs][..., :CUT]
    assert not (clicks * (1 - mask)).any()
    np.testing.assert_array_equal(valid, clicks.sum(-1) > 0)
    m = want_valid.size
    p, got = want_valid.mean(), valid.mean()
    assert abs(got - p) <= 4 * np.sqrt(2 * max(p * (1 - p), 1e-3) / m)
    rate, want_rate = clicks.mean((0, 1)), want_clicks.mean((0, 1))
    sigma = np.sqrt(2 * np.maximum(want_rate * (1 - want_rate), 1e-3) / m)
    assert (np.abs(rate - want_rate) <= 4 * sigma).all()


def test_lists_never_clicked_are_masked(click_json):
    """With a pool of exactly B draws some slots stay unclicked; their
    lists are masked out of the loss, as in the JAX feed."""
    _, feed = _pair(click_json, "resample_overdraw=1", batch=64)
    plan = feed.train_batch_plan(torch.Generator().manual_seed(1), 0, 20)
    assert not plan[2].all()
    for i in range(20):
        batch = feed.batch_from_plan(plan, i)
        qs = plan[0][i]
        want = feed.dataset.mask[qs][:, :CUT] * plan[2][i][:, None]
        torch.testing.assert_close(batch["mask"], want, rtol=0, atol=0)
        torch.testing.assert_close(batch["labels"], plan[1][i], rtol=0,
                                   atol=0)
        assert batch["features"].shape == (64, CUT, F)


def test_compact_pool_keeps_clicked_lists_first(click_json):
    _, feed = _pair(click_json)
    _, _, valid = feed.train_batch_plan(torch.Generator().manual_seed(2), 0,
                                        50)
    assert valid.float().mean() > 0.99


def test_dynamic_bias_eta_schedule_equals_jax(click_json):
    hp = "dynamic_bias_eta_change=0.25,dynamic_bias_step_interval=3"
    jax_feed, feed = _pair(click_json, hp)
    steps = np.arange(0, 20)
    got = feed._eta_at_steps(torch.from_numpy(steps)).numpy()
    want = [float(jax_feed._eta_at_step(jnp.int32(s))) for s in steps]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert feed._p_click_lo is None and jax_feed._p_click_lo is None


def test_direct_label_feed_batches(click_json):
    jax_feed, feed = _pair(click_json, cls="DirectLabelFeed", batch=64)
    starts = [s for _, s, _ in feed.eval_batches()]
    counts = [c for _, _, c in feed.eval_batches()]
    want = [(s, c) for _, s, c in jax_feed.eval_batches()]
    assert list(zip(starts, counts)) == want
    batch = feed.batch_from_plan(
        feed.train_batch_plan(torch.Generator().manual_seed(0), 0, 2), 1)
    assert batch["features"].shape == (64, L, F)
