"""K5, the PBM click sampler, and the PBM click model against JAX (UBM
and cascade are held in ``test_torch_click_models.py``).

The kernel's random bits are Philox4x32-10, which the JAX sampler does
not use, so the two are compared in two ways: given JAX's own uniforms,
the comparison ``u < exam^eta * click_prob`` gives JAX's clicks exactly;
and the port's Philox stream gives per-position click rates within 4
sigma of the JAX sampler's. The Philox stream itself is held to the
known-answer vectors of its authors (Salmon et al., Random123).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX package is the reference here
pytest.importorskip("flax")  # its click models and algorithms need it

from ultra_pytorch_tpu.sim import click_models as jax_cm
from ultra_pytorch_tpu_torch.ops.kernels import click_sim
from ultra_pytorch_tpu_torch.sim import click_models as cm
from ultra_pytorch_tpu_torch.utils import spans

# Random123's known answers for philox4x32_10: (counter, key, output).
PHILOX_KAT = [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _labels(seed, shape, grades=5):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, grades, size=shape).astype(np.float32)
    mask = (rng.random(shape) < 0.9).astype(np.float32)
    return labels, mask


@pytest.mark.parametrize("counter,key,want", PHILOX_KAT)
def test_philox_known_answers(counter, key, want):
    got = click_sim.philox4x32_10(torch.tensor([counter], dtype=torch.int64),
                                  torch.tensor(key, dtype=torch.int64))
    assert [int(v) for v in got[0]] == list(want)


@pytest.mark.parametrize("eta", [1.0, 0.5])
def test_clicks_from_uniform_equal_jax_clicks(eta):
    labels, mask = _labels(0, (64, 10))
    key = jax.random.PRNGKey(3)
    jax_model = jax_cm.make_click_model("pbm", 0.1, 1.0, 4, eta)
    want, want_exam, want_click = jax_cm.sample_clicks(jax_model, key,
                                                       labels, mask)
    u = np.array(jax.random.uniform(key, labels.shape))
    model = cm.make_click_model("pbm", 0.1, 1.0, 4, eta)
    probs = cm.click_probs(model, torch.from_numpy(labels))
    got = click_sim.clicks_from_uniform(probs, torch.from_numpy(u),
                                        torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _, exam, click = cm.sample_clicks(model, torch.Generator().manual_seed(0),
                                      torch.from_numpy(labels),
                                      torch.from_numpy(mask))
    np.testing.assert_array_equal(exam.numpy(), np.asarray(want_exam))
    np.testing.assert_array_equal(click.numpy(), np.asarray(want_click))


def test_wrapper_on_cpu_is_the_plain_version():
    labels, mask = _labels(1, (3, 7, 10))
    probs = torch.rand(labels.shape,
                       generator=torch.Generator().manual_seed(1))
    key = torch.tensor([12345, 67890], dtype=torch.int64)
    before = spans.counters()["launches.K5"]
    got = click_sim.pbm_clicks(probs, torch.from_numpy(mask), key)
    assert spans.counters()["launches.K5"] == before
    torch.testing.assert_close(
        got, click_sim.pbm_clicks_reference(probs, torch.from_numpy(mask),
                                            key), rtol=0, atol=0)
    with pytest.raises(ValueError, match="two words"):
        click_sim.pbm_clicks(probs, torch.from_numpy(mask), key.int())


def test_philox_uniforms_are_uniform():
    n = 1 << 16
    u = click_sim.philox_uniform(torch.tensor([7, 11]), n).numpy()
    assert u.min() >= 0.0 and u.max() < 1.0
    assert abs(u.mean() - 0.5) < 4 * np.sqrt(1 / 12 / n)
    counts = np.histogram(u, bins=16, range=(0.0, 1.0))[0]
    expected = n / 16
    chi2 = ((counts - expected) ** 2 / expected).sum()
    assert chi2 < 50.0  # 15 degrees of freedom: p < 1e-5 above 50
    # (bits >> 8) * 2^-24: every value on the 24-bit grid.
    assert np.array_equal(u * (1 << 24), np.floor(u * (1 << 24)))


def test_distinct_keys_give_distinct_streams():
    base = click_sim.philox_uniform(torch.tensor([1, 2]), 4096)
    for key in ([1, 3], [2, 2], [0, 2]):
        other = click_sim.philox_uniform(torch.tensor(key), 4096)
        assert (base == other).float().mean() < 0.01
    assert torch.equal(base, click_sim.philox_uniform(torch.tensor([1, 2]),
                                                      4096))


def test_position_rates_match_the_jax_sampler():
    n = 20000
    labels, mask = _labels(2, (n, 10))
    jax_model = jax_cm.make_click_model("pbm", 0.1, 1.0, 4, 1.0)
    want, _, _ = jax_cm.sample_clicks(jax_model, jax.random.PRNGKey(5),
                                      labels, mask)
    model = cm.make_click_model("pbm", 0.1, 1.0, 4, 1.0)
    got = click_sim.sample_pbm_clicks(model, torch.Generator().manual_seed(5),
                                      torch.from_numpy(labels),
                                      torch.from_numpy(mask))
    p = np.asarray(want).mean(0)
    rate = got.numpy().mean(0)
    sigma = np.sqrt(2 * np.maximum(p * (1 - p), 1e-4) / n)
    assert (np.abs(rate - p) <= 4 * sigma).all(), (rate, p)
    assert not (got.numpy() * (1 - mask)).any()


def test_per_step_eta_matches_one_eta_at_a_time():
    labels, _ = _labels(3, (3, 5, 10))
    model = cm.make_click_model("pbm", 0.1, 1.0, 4, 1.0)
    etas = torch.tensor([1.0, 1.5, 2.0])
    batched = cm.click_probs(model.replace(eta=etas),
                             torch.from_numpy(labels))
    for i, eta in enumerate(etas):
        one = cm.click_probs(model.replace(eta=eta),
                             torch.from_numpy(labels[i]))
        torch.testing.assert_close(batched[i], one, rtol=0, atol=0)


def test_click_model_files_match_jax(tmp_path):
    cm.main(["pbm", "0.1", "1.0", "4", "0.5", str(tmp_path)])
    written = tmp_path / "pbm_0.1_1.0_4_0.5.json"
    assert written.is_file()
    assert cm.click_model_json_numpy("pbm", 0.1, 1.0, 4, 0.5) == \
        jax_cm.click_model_json_numpy("pbm", 0.1, 1.0, 4, 0.5)
    mine = cm.load_model_from_file(str(written))
    theirs = jax_cm.load_model_from_file(str(written))
    np.testing.assert_array_equal(mine.click_prob.numpy(),
                                  np.asarray(theirs.click_prob))
    assert float(mine.eta) == float(theirs.eta)


@pytest.mark.parametrize("name", ["ubm", "cascade"])
def test_other_click_models_are_not_yet_ported(name):
    """UBM and cascade are ported: ``make_click_model`` builds JAX's
    tables, and a JSON written by the port loads in JAX (and back) as the
    same model."""
    mine = cm.make_click_model(name, 0.1, 1.0, 4, 1.0)
    theirs = jax_cm.make_click_model(name, 0.1, 1.0, 4, 1.0)
    assert mine.model_name == theirs.model_name
    for a, b in ((mine.exam_prob, theirs.exam_prob),
                 (mine.click_prob, theirs.click_prob)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    crossed = jax_cm.load_model_from_json(cm.model_to_json(mine))
    back = cm.load_model_from_json(jax_cm.model_to_json(crossed))
    assert back.model_name == crossed.model_name == mine.model_name
    np.testing.assert_array_equal(np.asarray(crossed.exam_prob),
                                  mine.exam_prob.numpy())
    np.testing.assert_array_equal(back.exam_prob.numpy(),
                                  mine.exam_prob.numpy())
    assert float(back.eta) == float(crossed.eta) == 1.0
