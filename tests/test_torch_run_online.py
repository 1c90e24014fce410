"""The online family through the port's entry points: the six configs of
``configs/`` (``naive_online``, ``pdgd``, ``dbgd``, ``dbgd_ndcg``,
``mgd``, ``nsgd``) trained through the CLI (``python -m
ultra_pytorch_tpu_torch.run --device cpu``) for two windows with a
ranklist from ``--test_only``; a restored ``Experiment`` reproducing the
next window bit for bit (the online feeds draw a batch a step from the
window's generator, before the algorithm's draws); and NSGD's checkpoint,
with its bad-noise memory, read in both directions with the JAX
package's ``Experiment`` and served by a ``Scorer``.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX package is the reference here
pytest.importorskip("flax")  # its click models and algorithms need it

from ultra_pytorch_tpu.run.experiment import (  # noqa: E402
    Experiment as JaxExperiment)
from ultra_pytorch_tpu_torch.run.experiment import Experiment  # noqa: E402
from ultra_pytorch_tpu_torch.serve import Scorer  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")
CONFIGS = ("naive_online", "pdgd", "dbgd", "dbgd_ndcg", "mgd", "nsgd")
# The configs whose steps report the shown list's metrics.
ONLINE_METRICS = ("pdgd", "dbgd", "mgd", "nsgd")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _settings(config):
    """The config's settings with its click-model paths made absolute."""
    with open(os.path.join(REPO, "configs", f"{config}.json")) as fin:
        text = fin.read()
    return json.loads(text.replace("./example/",
                                   os.path.join(REPO, "example") + "/"))


def _run(args):
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "ultra_pytorch_tpu_torch.run"] + args,
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, (
        f"CLI failed:\nSTDOUT:\n{proc.stdout}\nSTDERR:\n{proc.stderr}")
    return proc.stdout


@pytest.mark.parametrize("config", CONFIGS)
def test_configs_train_and_test_through_the_cli(tmp_path, config):
    """Two windows of two steps from the repo root (where the config's
    click-model paths point): finite losses, the online metrics finite
    where the algorithm reports them, a checkpoint, and ``--test_only``
    writing one TREC line per test document."""
    model_dir, out_dir = tmp_path / "model", tmp_path / "out"
    common = ["--device", "cpu", "--data_dir", DATA,
              "--setting_file", os.path.join(REPO, "configs",
                                             f"{config}.json"),
              "--model_dir", str(model_dir)]
    stdout = _run(common + ["--batch_size", "8", "--max_train_iteration",
                            "4", "--steps_per_checkpoint", "2"])
    assert "Training done at step 4" in stdout
    lines = [line.split("|")[0].split() for line in stdout.splitlines()
             if line.startswith("step ")]
    assert len(lines) == 2
    for words in lines:
        assert np.isfinite(float(words[3]))
        online = {k: float(v) for k, v in zip(words[6::2], words[7::2])}
        if config in ONLINE_METRICS:
            assert sorted(online) == ["online_ndcg", "online_reward"]
            assert all(np.isfinite(v) for v in online.values())
            assert 0.0 <= online["online_ndcg"] <= 1.0
        else:
            assert not online
    algo = _settings(config)["learning_algorithm"].rsplit(".", 1)[-1]
    assert (model_dir / f"{algo}.ckpt.npz").is_file()

    stdout = _run(common + ["--output_dir", str(out_dir), "--test_only"])
    assert "ndcg_10:" in stdout and "WARNING: no checkpoint" not in stdout
    ranklist = (out_dir / "test.ranklist").read_text().splitlines()
    assert ranklist and all(len(line.split()) == 6 for line in ranklist)


def _experiment(config, model_dir):
    exp = Experiment(_settings(config), DATA, str(model_dir), batch_size=8,
                     device="cpu").setup(("train", "valid"))
    exp.init_state()
    return exp


@pytest.mark.parametrize("config", CONFIGS)
def test_restored_run_reproduces_the_next_window(tmp_path, config):
    exp = _experiment(config, tmp_path)
    exp.train_steps(2)
    exp.save({"step": 2})
    want_metrics = exp.train_steps(2)
    want = exp.algorithm.state_leaves(exp.state) + [exp._data_key]

    again = _experiment(config, tmp_path)
    assert again.restore()
    got_metrics = again.train_steps(2)
    got = again.algorithm.state_leaves(again.state) + [again._data_key]
    assert got_metrics == want_metrics
    if config in ONLINE_METRICS:
        assert {"online_reward", "online_ndcg"} <= set(got_metrics)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def _leaves(exp, jax_side):
    if jax_side:
        return [np.asarray(x) for x in jax.tree_util.tree_leaves(
            (exp.state, exp._data_rng))]
    return exp.algorithm.state_leaves(exp.state) + [exp._data_key]


def test_nsgd_checkpoints_cross_both_ways_and_serve(tmp_path):
    """JAX trains 2 NSGD steps and saves; the port restores every leaf
    (the bad-noise memory included), trains 2 more and saves; JAX restores
    the port's leaves bit for bit. A ``Scorer`` serves the port's
    checkpoint as the Experiment scores."""
    settings = _settings("nsgd")
    jexp = JaxExperiment(dict(settings), DATA, str(tmp_path / "jax"),
                         batch_size=8, dp="off").setup(("train", "valid"))
    jexp.init_state()
    jexp.train_steps(2)
    jexp.save({"step": 2})
    exp = _experiment("nsgd", tmp_path / "port")
    assert exp.restore(jexp.ckpt_path)
    mine, theirs = _leaves(exp, False), _leaves(jexp, True)
    assert len(mine) == len(theirs)
    for a, b in zip(mine, theirs):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert len(exp.state.aux["bad_noise"]) == len(
        exp.state.params.jax_leaves())

    exp.train_steps(2)
    exp.save({"step": 4})
    back = JaxExperiment(dict(settings), DATA, str(tmp_path / "port"),
                         batch_size=8, dp="off").setup(("train", "valid"))
    back.init_state()
    assert back.restore()
    for a, b in zip(_leaves(back, True), _leaves(exp, False)):
        np.testing.assert_array_equal(a, np.asarray(b))

    scorer = Scorer.from_checkpoint(str(tmp_path / "port"), device="cpu")
    batch, _, count = next(exp.feeds["valid"].eval_batches())
    direct = exp.algorithm.score(exp.state, batch)[:count].numpy()
    n_valid = batch["mask"][:count].sum(1).int().numpy()
    served = scorer.score(batch["features"][:count].numpy(), n_valid)
    for row, n in enumerate(n_valid):
        np.testing.assert_allclose(served[row, :n], direct[row, :n],
                                   rtol=1e-5, atol=1e-5)
