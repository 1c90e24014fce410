"""The convergence study (``torch_convergence.py``) at a narrow width on the
CPU: the port's trainer against the JAX package's, live, on learnable
synthetic data. DLA and PDGD, hidden [32, 16], F = 16, 200 train
queries, 300 steps, 3 seeds a side: the band holds, a port run that
cannot learn (``learning_rate=0``) falls outside it, and the generator
still writes the files whose sha256s the full protocol's fixture
(``tests/torch_convergence_expected.json``) holds."""

import json
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch_convergence as conv  # noqa: E402
import torch_convergence_jax as conv_jax  # noqa: E402

HIDDEN = [32, 16]
STEPS = 300
SEEDS = 3
SMALL = {"train_queries": 200, "valid_queries": 100, "features": 16,
         "min_nnz": 4, "max_nnz": 8, "init_noise": 1.25}


@pytest.fixture(scope="module", autouse=True)
def _threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def small_data(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("conv") / "data")
    generated = conv.generate(out, **SMALL)
    return out, generated


@pytest.fixture(scope="module")
def jax_runs(small_data):
    data_dir, _ = small_data
    return {name: [conv_jax.run_jax(name, seed, data_dir, STEPS, HIDDEN)
                   for seed in range(SEEDS)]
            for name in ("DLA", "PDGD")}


def _port_runs(name, data_dir, overrides=None):
    datasets = conv.load_datasets(data_dir)
    return [conv.run_port(name, seed, data_dir, STEPS, "cpu", HIDDEN,
                          datasets=datasets, overrides=overrides)
            for seed in range(SEEDS)]


@pytest.mark.parametrize("name", ["DLA", "PDGD"])
def test_port_falls_in_the_jax_band(name, small_data, jax_runs):
    data_dir, generated = small_data
    assert 0.70 <= generated["initial_ndcg_10"]["valid"] <= 0.85
    port = _port_runs(name, data_dir)
    for run in port:
        assert run["steps"] == list(range(0, STEPS + 1, 50))
        assert run["windows"] == "CUDA graphs exist only on the card"
    verdict = conv.band(port, jax_runs[name])
    assert verdict["ok"], conv.describe(name, verdict)


def test_a_port_that_cannot_learn_falls_outside_the_band(small_data,
                                                         jax_runs):
    data_dir, _ = small_data
    frozen = _port_runs("DLA", data_dir, overrides="learning_rate=0.0")
    verdict = conv.band(frozen, jax_runs["DLA"])
    assert not verdict["peak"]["inside"]
    assert not verdict["final"]["inside"]
    assert verdict["gain_port"] < conv.MIN_GAIN <= verdict["gain_jax"]
    assert not verdict["ok"]


def test_band_arithmetic():
    runs = [{"peak": p, "final": p, "untrained": 0.5}
            for p in (0.90, 0.92, 0.94)]
    near = [{"peak": p + 0.005, "final": p + 0.005, "untrained": 0.5}
            for p in (0.90, 0.92, 0.94)]
    far = [{"peak": p + 0.05, "final": p + 0.05, "untrained": 0.5}
           for p in (0.90, 0.92, 0.94)]
    # s = 0.02 on both sides, n = 3: 4 * sqrt(2 * 0.0004 / 3) = 0.0653.
    width = 4 * (2 * 0.02 ** 2 / 3) ** 0.5
    assert conv.band(near, runs)["peak"]["band"] == pytest.approx(width)
    assert conv.band(near, runs)["ok"]
    assert conv.band(far, runs)["peak"]["inside"] is True   # 0.05 < 0.0653
    flat = [{"peak": 0.9, "final": 0.9, "untrained": 0.5}] * 3
    assert conv.band([dict(r, peak=0.915, final=0.915) for r in flat],
                     flat)["peak"]["band"] == conv.BAND_FLOOR
    assert not conv.band([dict(r, peak=0.915, final=0.915) for r in flat],
                         flat)["ok"]
    lazy = [dict(r, untrained=0.88) for r in flat]
    assert not conv.band(lazy, lazy)["ok"]   # gain 0.02 < 0.05


def test_generator_matches_the_fixture(tmp_path):
    with open(conv.EXPECTED) as fin:
        expected = json.load(fin)
    generated = conv.generate(str(tmp_path / "data"),
                              **expected["generator"]["args"])
    assert conv.check_files(generated, expected) == []
    assert expected["generator"]["args"] == conv.GENERATOR
    assert expected["protocol"] == conv.PROTOCOL
    assert set(expected["algorithms"]) == set(conv.ALGORITHMS)
    for name, entry in expected["algorithms"].items():
        steps = conv.ALGORITHMS[name][1]
        assert len(entry["runs"]) >= 4, name
        for run in entry["runs"]:
            assert run["steps"] == list(range(0, steps + 1, 50)), name
        assert conv.band(entry["runs"], entry["runs"])["ok"], name
