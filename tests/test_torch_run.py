"""The port's training entry points: ``Experiment``, its checkpoints read
in both directions with the JAX package's ``Experiment``, and the CLI
(``python -m ultra_pytorch_tpu_torch.run --device cpu``) on the toy data.
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

from ultra_pytorch_tpu.run.experiment import Experiment as JaxExperiment
from ultra_pytorch_tpu_torch.run import __main__ as cli
from ultra_pytorch_tpu_torch.run.experiment import Experiment
from ultra_pytorch_tpu_torch.utils import checkpoint as ckpt_lib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _settings(click_model_json, kernels=False, algorithm="DLA"):
    ranker = "hidden_layer_sizes=[16]"
    algo = ""
    feed = f"click_model_json={click_model_json}"
    if kernels:
        ranker += ",use_pallas=true"
        algo = "loss_func=fused_softmax_loss"
        feed += ",use_pallas_click=true"
    return {
        "train_input_feed": "ClickSimulationFeed",
        "train_input_hparams": feed,
        "valid_input_feed": "DirectLabelFeed", "valid_input_hparams": "",
        "test_input_feed": "DirectLabelFeed", "test_input_hparams": "",
        "ranking_model": "DNN", "ranking_model_hparams": ranker,
        "learning_algorithm": algorithm, "learning_algorithm_hparams": algo,
        "metrics": ["ndcg", "mrr"], "metrics_topn": [3, 5],
        "objective_metric": "ndcg_5", "selection_bias_cutoff": 5,
    }


def _port(settings, data_dir, model_dir, splits=("train", "valid")):
    exp = Experiment(dict(settings), data_dir, model_dir, batch_size=8,
                     device="cpu").setup(splits)
    exp.init_state()
    return exp


def _jax(settings, data_dir, model_dir, splits=("train", "valid")):
    exp = JaxExperiment(dict(settings), data_dir, model_dir, batch_size=8,
                        dp="off").setup(splits)
    exp.init_state()
    return exp


def _jax_leaves(exp):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(
        (exp.state, exp._data_rng))]


def _port_leaves(exp):
    return exp.algorithm.state_leaves(exp.state) + [exp._data_key]


def test_jax_checkpoint_loads_into_the_port(toy_data_dir, click_model_json,
                                            tmp_path):
    settings = _settings(click_model_json)
    jexp = _jax(settings, toy_data_dir, str(tmp_path))
    jexp.train_steps(3)
    jexp.save({"step": 3})
    exp = _port(settings, toy_data_dir, str(tmp_path))
    assert exp.restore()
    mine, theirs = _port_leaves(exp), _jax_leaves(jexp)
    assert len(mine) == len(theirs)
    for a, b in zip(mine, theirs):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert exp.state.step == 3
    # On the same weights, validation (tie-free scores) and test scores
    # agree with the JAX package's.
    want = jexp.validate("valid")
    got = exp.validate("valid")
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6)


def test_port_checkpoint_loads_into_jax(toy_data_dir, click_model_json,
                                        tmp_path):
    settings = _settings(click_model_json)
    exp = _port(settings, toy_data_dir, str(tmp_path))
    exp.train_steps(3)
    exp.save({"step": 3})
    jexp = _jax(settings, toy_data_dir, str(tmp_path))
    assert jexp.restore()
    for a, b in zip(_jax_leaves(jexp), _port_leaves(exp)):
        np.testing.assert_array_equal(a, np.asarray(b))
    scores = exp.test_scores("valid")
    np.testing.assert_allclose(scores, jexp.test_scores("valid"), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("algorithm", ["RegressionEM", "PairDebias"])
def test_aux_state_checkpoints_cross_both_ways(toy_data_dir,
                                               click_model_json, tmp_path,
                                               algorithm):
    """Regression-EM's propensity and PairDebias' t+/t- go through
    checkpoints in both directions leaf for leaf."""
    settings = _settings(click_model_json, algorithm=algorithm)
    jexp = _jax(settings, toy_data_dir, str(tmp_path / "jax"))
    jexp.train_steps(3)
    jexp.save({"step": 3})
    exp = _port(settings, toy_data_dir, str(tmp_path / "port"))
    assert exp.restore(jexp.ckpt_path)
    mine, theirs = _port_leaves(exp), _jax_leaves(jexp)
    assert len(mine) == len(theirs)
    for a, b in zip(mine, theirs):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert exp.state.step == 3

    exp.train_steps(2)
    exp.save({"step": 5})
    back = _jax(settings, toy_data_dir, str(tmp_path / "port"))
    assert back.restore()
    for a, b in zip(_jax_leaves(back), _port_leaves(exp)):
        np.testing.assert_array_equal(a, np.asarray(b))
    aux = exp.state.aux
    assert all(bool(torch.isfinite(t).all()) for t in aux.values())


def test_restore_continues_the_same_run(toy_data_dir, click_model_json,
                                        tmp_path):
    """Two windows straight through equal one window, a checkpoint, a
    fresh Experiment restoring it and the second window: the data key is
    part of the state."""
    settings = _settings(click_model_json, kernels=True)
    straight = _port(settings, toy_data_dir, str(tmp_path / "a"))
    straight.train_steps(2)
    straight.train_steps(2)
    first = _port(settings, toy_data_dir, str(tmp_path / "b"))
    first.train_steps(2)
    first.save()
    resumed = _port(settings, toy_data_dir, str(tmp_path / "b"))
    assert resumed.restore()
    resumed.train_steps(2)
    for a, b in zip(_port_leaves(straight), _port_leaves(resumed)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_restore_continues_the_same_regression_em_run(
        toy_data_dir, click_model_json, tmp_path):
    """Regression-EM draws its uniforms from the window's generator after
    the plan, so a restored run continues the same stream too."""
    settings = _settings(click_model_json, kernels=True,
                         algorithm="RegressionEM")
    settings["learning_algorithm_hparams"] = ""   # it has no loss_func
    straight = _port(settings, toy_data_dir, str(tmp_path / "a"))
    straight.train_steps(2)
    straight.train_steps(2)
    first = _port(settings, toy_data_dir, str(tmp_path / "b"))
    first.train_steps(2)
    first.save()
    resumed = _port(settings, toy_data_dir, str(tmp_path / "b"))
    assert resumed.restore()
    resumed.train_steps(2)
    for a, b in zip(_port_leaves(straight), _port_leaves(resumed)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_restore_params_only_and_guards(toy_data_dir, click_model_json,
                                        tmp_path):
    settings = _settings(click_model_json)
    exp = _port(settings, toy_data_dir, str(tmp_path))
    exp.train_steps(2)
    exp.save({"state_format": "opt-per-leaf-r3"})
    fresh = _port(settings, toy_data_dir, str(tmp_path))
    with pytest.raises(ValueError, match="restore_params_only"):
        fresh.restore()
    assert fresh.restore(params_only=True)
    for a, b in zip(exp.algorithm.state_leaves(exp.state)[:4],
                    fresh.algorithm.state_leaves(fresh.state)[:4]):
        np.testing.assert_array_equal(a, b)
    assert fresh.state.step == 0
    with pytest.raises(FileNotFoundError):
        fresh.restore(str(tmp_path / "missing.ckpt"))


def test_entry_points_default_to_cuda(toy_data_dir, click_model_json,
                                      monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Experiment(_settings(click_model_json), toy_data_dir, "unused")
    assert cli.parse_args([]).device == "cuda"


@pytest.mark.parametrize("kwargs", [{"dp": 2}, {"dp": "4"},
                                    {"shard_data": True}])
def test_unported_parallelism_raises(click_model_json, kwargs):
    """Data parallelism is ported: an Experiment is one rank of a process
    group, so `dp` > 1 or `shard_data` without a group is an error."""
    with pytest.raises(ValueError, match="process group|requires a data"):
        Experiment(_settings(click_model_json), "unused", "unused",
                   device="cpu", **kwargs)


@pytest.mark.parametrize("flags", [["--prng", "rbg"],
                                   ["--prng", "unsafe_rbg"]])
def test_prng_rbg_flags_train_and_restore(toy_data_dir, click_model_json,
                                          tmp_path, flags):
    """``--prng rbg`` / ``unsafe_rbg`` train through the CLI with rbg's
    four-word data key, recorded in the checkpoint; a checkpoint the JAX
    package wrote under that ``--prng`` restores into the port leaf for
    leaf, and a run under another ``--prng`` refuses it, naming the
    flag."""
    prng = flags[1]
    settings = _settings(click_model_json)
    setting_file = tmp_path / "settings.json"
    setting_file.write_text(json.dumps(settings))
    model_dir = tmp_path / "cli"
    cli.main(["--device", "cpu", "--data_dir", toy_data_dir,
              "--setting_file", str(setting_file), "--model_dir",
              str(model_dir), "--batch_size", "8", "--max_train_iteration",
              "4", "--steps_per_checkpoint", "2"] + flags)
    ckpt = str(model_dir / "DLA.ckpt")
    assert ckpt_lib.read_metadata(ckpt)["prng_impl"] == prng
    again = Experiment(dict(settings), toy_data_dir, str(model_dir),
                       batch_size=8, device="cpu", prng_impl=prng).setup()
    assert again.restore()
    assert again._data_key.shape == (4,) and again.state.step > 0

    try:
        jax.config.update("jax_default_prng_impl", prng)
        jexp = _jax(settings, toy_data_dir, str(tmp_path / "jax"))
        jexp.train_steps(3)
        jexp.save({"step": 3})
        theirs = _jax_leaves(jexp)
    finally:
        jax.config.update("jax_default_prng_impl", "threefry2x32")
    exp = Experiment(dict(settings), toy_data_dir, str(tmp_path / "port"),
                     batch_size=8, device="cpu", prng_impl=prng).setup()
    exp.init_state()
    assert exp.restore(jexp.ckpt_path)
    mine = _port_leaves(exp)
    assert len(mine) == len(theirs) and theirs[-1].shape == (4,)
    for a, b in zip(mine, theirs):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert exp.state.step == 3
    exp.train_steps(2)
    assert np.isfinite(exp.validate("valid")["ndcg_5"])

    default = _port(settings, toy_data_dir, str(tmp_path / "default"))
    with pytest.raises(ValueError, match="--prng"):
        default.restore(jexp.ckpt_path)


def _run(args, cwd):
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "ultra_pytorch_tpu_torch.run"] + args,
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, (
        f"CLI failed:\nSTDOUT:\n{proc.stdout}\nSTDERR:\n{proc.stderr}")
    return proc.stdout


def test_cli_train_then_test_only(toy_data_dir, click_model_json, tmp_path):
    setting_file = tmp_path / "settings.json"
    setting_file.write_text(json.dumps(_settings(click_model_json,
                                                 kernels=True)))
    model_dir, out_dir = tmp_path / "model", tmp_path / "out"
    common = ["--device", "cpu", "--data_dir", toy_data_dir,
              "--setting_file", str(setting_file),
              "--model_dir", str(model_dir)]
    stdout = _run(common + ["--batch_size", "8", "--max_train_iteration",
                            "10", "--steps_per_checkpoint", "4",
                            "--test_while_train"], cwd=str(tmp_path))
    assert "Training done at step 10" in stdout
    assert "saved checkpoint" in stdout and "test:" in stdout
    assert (model_dir / "DLA.ckpt.npz").is_file()
    logged = [json.loads(line) for line in
              (model_dir / "logs" / "metrics.jsonl").read_text().splitlines()]
    assert {r["split"] for r in logged} == {"train", "valid", "test"}

    stdout = _run(common + ["--output_dir", str(out_dir), "--test_only"],
                  cwd=str(tmp_path))
    assert "ndcg_5:" in stdout and "WARNING: no checkpoint" not in stdout
    lines = (out_dir / "test.ranklist").read_text().splitlines()
    first = lines[0].split()
    assert len(first) == 6 and first[1] == "Q0" and first[3] == "1"
    assert first[5] == "Model"


@pytest.mark.parametrize("config", [
    "naive", "naive_oracle", "ipw_rank", "regression_EM", "pairwise_debias",
    "lambda_rank", "prs_rank"])
def test_offline_configs_train_through_the_cli(tmp_path, config):
    """Each offline config of ``configs/`` trains through the port's CLI
    on the CPU (from the repo root, where its click-model and estimator
    paths point)."""
    model_dir = tmp_path / "model"
    setting_file = os.path.join(REPO, "configs", f"{config}.json")
    stdout = _run(["--device", "cpu",
                   "--data_dir", os.path.join(REPO, "tests", "data"),
                   "--setting_file", setting_file,
                   "--model_dir", str(model_dir), "--batch_size", "8",
                   "--max_train_iteration", "4",
                   "--steps_per_checkpoint", "2"], cwd=REPO)
    assert "Training done at step 4" in stdout
    with open(setting_file) as fin:
        algo = json.load(fin)["learning_algorithm"].rsplit(".", 1)[-1]
    assert (model_dir / f"{algo}.ckpt.npz").is_file()
    losses = [float(line.split()[3]) for line in stdout.splitlines()
              if line.startswith("step ")]
    assert len(losses) == 2 and all(np.isfinite(losses))
