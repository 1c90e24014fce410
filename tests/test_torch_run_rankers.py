"""The new rankers and click models through the port's entry points:
``Experiment`` checkpoints read in both directions with the JAX package's
``Experiment`` and served by a ``Scorer``, and the six configs of
``configs/`` that need them (``naive_cascade``, ``dla_ubm``,
``naive_linear``, ``dla_setrank``, ``dla_dlcm``, ``naive_gsf``) trained
through the CLI (``python -m ultra_pytorch_tpu_torch.run --device cpu``)
with a ranklist from ``--test_only``.
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
RANKERS = {
    "Linear": ("NaiveAlgorithm", ""),
    "GSF": ("NaiveAlgorithm", "group_size=2,hidden_layer_sizes=[16]"),
    "DLCM": ("DLA", "embed_size=8,hidden_size=6"),
    "SetRank": ("DLA", "d_model=16,num_heads=4,num_layers=1,diff=8"),
}
CONFIGS = ("naive_cascade", "dla_ubm", "naive_linear", "dla_setrank",
           "dla_dlcm", "naive_gsf")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _settings(click_model_json, ranker):
    algo, hp = RANKERS[ranker]
    return {
        "train_input_feed": "ClickSimulationFeed",
        "train_input_hparams": f"click_model_json={click_model_json}",
        "valid_input_feed": "DirectLabelFeed", "valid_input_hparams": "",
        "test_input_feed": "DirectLabelFeed", "test_input_hparams": "",
        "ranking_model": f"ultra.ranking_model.{ranker}",
        "ranking_model_hparams": hp,
        "learning_algorithm": algo, "learning_algorithm_hparams": "",
        "metrics": ["ndcg"], "metrics_topn": [5],
        "objective_metric": "ndcg_5", "selection_bias_cutoff": 5,
    }


def _leaves(exp, jax_side):
    if jax_side:
        return [np.asarray(x) for x in jax.tree_util.tree_leaves(
            (exp.state, exp._data_rng))]
    return exp.algorithm.state_leaves(exp.state) + [exp._data_key]


@pytest.mark.parametrize("ranker", list(RANKERS))
def test_checkpoints_cross_both_ways_and_serve(toy_data_dir,
                                               click_model_json, tmp_path,
                                               ranker):
    """JAX trains 2 steps and saves; the port restores every leaf, trains
    2 more and saves; JAX restores the port's leaves bit for bit. A
    ``Scorer`` serves the port's checkpoint as the Experiment scores."""
    settings = _settings(click_model_json, ranker)
    jexp = JaxExperiment(dict(settings), toy_data_dir, str(tmp_path / "jax"),
                         batch_size=8, dp="off").setup(("train", "valid"))
    jexp.init_state()
    jexp.train_steps(2)
    jexp.save({"step": 2})
    exp = Experiment(dict(settings), toy_data_dir, str(tmp_path / "port"),
                     batch_size=8, device="cpu").setup(("train", "valid"))
    exp.init_state()
    assert exp.restore(jexp.ckpt_path)
    mine, theirs = _leaves(exp, False), _leaves(jexp, True)
    assert len(mine) == len(theirs)
    for a, b in zip(mine, theirs):
        np.testing.assert_array_equal(np.asarray(a), b)

    exp.train_steps(2)
    exp.save({"step": 4})
    back = JaxExperiment(dict(settings), toy_data_dir, str(tmp_path / "port"),
                         batch_size=8, dp="off").setup(("train", "valid"))
    back.init_state()
    assert back.restore()
    for a, b in zip(_leaves(back, True), _leaves(exp, False)):
        np.testing.assert_array_equal(a, np.asarray(b))
    np.testing.assert_allclose(exp.test_scores("valid"),
                               back.test_scores("valid"), rtol=1e-5,
                               atol=1e-5)

    scorer = Scorer.from_checkpoint(str(tmp_path / "port"), device="cpu")
    assert type(scorer.ranker) is type(exp.state.params)
    assert not scorer.ranker.hparams.get("use_pallas")
    batch, _, count = next(exp.feeds["valid"].eval_batches())
    direct = exp.algorithm.score(exp.state, batch)[:count].numpy()
    n_valid = batch["mask"][:count].sum(1).int().numpy()
    served = scorer.score(batch["features"][:count].numpy(), n_valid)
    for row, n in enumerate(n_valid):
        np.testing.assert_allclose(served[row, :n], direct[row, :n],
                                   rtol=1e-5, atol=1e-5)


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
    """Each config trains 4 steps from the repo root (where its
    click-model path points), keeps a checkpoint, and ``--test_only``
    writes one TREC line per test document."""
    model_dir, out_dir = tmp_path / "model", tmp_path / "out"
    common = ["--device", "cpu",
              "--data_dir", os.path.join(REPO, "tests", "data"),
              "--setting_file", os.path.join(REPO, "configs",
                                             f"{config}.json"),
              "--model_dir", str(model_dir)]
    stdout = _run(common + ["--batch_size", "8", "--max_train_iteration",
                            "4", "--steps_per_checkpoint", "2"])
    assert "Training done at step 4" in stdout
    losses = [float(line.split()[3]) for line in stdout.splitlines()
              if line.startswith("step ")]
    assert len(losses) == 2 and all(np.isfinite(losses))
    with open(os.path.join(REPO, "configs", f"{config}.json")) as fin:
        algo = json.load(fin)["learning_algorithm"].rsplit(".", 1)[-1]
    assert (model_dir / f"{algo}.ckpt.npz").is_file()

    stdout = _run(common + ["--output_dir", str(out_dir), "--test_only"])
    assert "ndcg_10:" in stdout and "WARNING: no checkpoint" not in stdout
    lines = (out_dir / "test.ranklist").read_text().splitlines()
    assert lines and all(len(line.split()) == 6 for line in lines)
    assert {line.split()[1] for line in lines} == {"Q0"}
