"""Two behaviours of the port held to the JAX package's.

* ``use_pallas_click=true`` with a UBM or cascade click model: the JAX
  feed takes its kernel branch for PBM alone and samples every other
  model with the click model's sampler, so such a config trains. The
  port's does the same: ``configs/dla_ubm.json`` and
  ``configs/naive_cascade.json`` with ``use_pallas_click=true`` (and
  ``use_pallas=true``) train on the CPU, and their runs equal the same
  configs without the flag bit for bit under one seed. The JAX package
  trains the same configs, and there too the flag changes no loss and no
  state.
* The training CLI's two ends (``main.py``): a window's mean loss stops
  the run when it is nan or +inf (``main.py``'s expression, read from its
  source, against the port's ``diverged_loss``), and a run that wrote no
  checkpoint saves its final state at its end, also after a divergence: a
  tiny run at an absurd learning rate leaves a checkpoint in either
  package's model directory, with the same lines printed.
"""

import ast
import json
import math
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX package is the reference here
pytest.importorskip("flax")  # its click models and algorithms need it

from ultra_pytorch_tpu.run.experiment import (  # noqa: E402
    Experiment as JaxExperiment)
from ultra_pytorch_tpu_torch.run import __main__ as cli  # noqa: E402
from ultra_pytorch_tpu_torch.run.experiment import Experiment  # noqa: E402
from ultra_pytorch_tpu_torch.utils import checkpoint as ckpt_lib  # noqa

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _config(name, *extras):
    """``configs/<name>.json`` with its click-model path made absolute and
    `extras` appended to (feed, ranker) hparams."""
    with open(os.path.join(ROOT, "configs", f"{name}.json")) as fin:
        settings = json.loads(fin.read().replace(
            "./example/", os.path.join(ROOT, "example") + "/"))
    feed, ranker = extras
    settings["train_input_hparams"] += feed
    settings["ranking_model_hparams"] += ranker
    return settings


def _port_run(settings, data_dir, model_dir):
    exp = Experiment(settings, data_dir, model_dir, batch_size=8,
                     device="cpu").setup(("train", "valid"))
    exp.init_state()
    metrics = [exp.train_steps(3) for _ in range(2)]
    return exp, metrics


@pytest.mark.parametrize("config", ["dla_ubm", "naive_cascade"])
def test_the_click_flag_with_ubm_and_cascade_trains_as_without(
        config, toy_data_dir, tmp_path):
    on, on_metrics = _port_run(
        _config(config, ",use_pallas_click=true", ",use_pallas=true"),
        toy_data_dir, str(tmp_path / "on"))
    off, off_metrics = _port_run(
        _config(config, "", ",use_pallas=true"), toy_data_dir,
        str(tmp_path / "off"))
    assert on.feeds["train"].hparams.use_pallas_click is True
    assert on.feeds["train"].click_model.model_name in (
        "user_browsing_model", "cascade_model")
    assert on_metrics == off_metrics
    assert all(math.isfinite(m["loss"]) for m in on_metrics)
    for a, b in zip(on.algorithm.state_leaves(on.state),
                    off.algorithm.state_leaves(off.state)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert on.validate() == off.validate()


def _jax_run(settings, data_dir, model_dir):
    exp = JaxExperiment(settings, data_dir, model_dir, batch_size=8,
                        dp="off").setup(("train", "valid"))
    exp.init_state()
    metrics = [exp.train_steps(2) for _ in range(2)]
    return exp, metrics


@pytest.mark.parametrize("config", ["dla_ubm", "naive_cascade"])
def test_the_jax_package_trains_the_same_config(config, toy_data_dir,
                                                tmp_path):
    """The JAX package trains the config with the flag, and the flag
    changes nothing there either: the same losses and state as without
    it from the same seed, the property the port copies."""
    on, on_metrics = _jax_run(
        _config(config, ",use_pallas_click=true", ",use_pallas=true"),
        toy_data_dir, str(tmp_path / "on"))
    off, off_metrics = _jax_run(
        _config(config, "", ",use_pallas=true"), toy_data_dir,
        str(tmp_path / "off"))
    assert on.feeds["train"].hparams.use_pallas_click is True
    assert off.feeds["train"].hparams.use_pallas_click is False
    assert all(math.isfinite(m["loss"]) for m in on_metrics)
    assert [m["loss"] for m in on_metrics] == [m["loss"]
                                               for m in off_metrics]
    for a, b in zip(jax.tree_util.tree_leaves(on.state),
                    jax.tree_util.tree_leaves(off.state)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# -- the CLI's two ends ------------------------------------------------------

def _jax_divergence_test():
    """``main.py``'s divergence test, ``diverged = <expr>`` inside its
    train loop, as a function of the loss."""
    with open(os.path.join(ROOT, "main.py")) as fin:
        tree = ast.parse(fin.read())
    node = next(n for n in ast.walk(tree) if isinstance(n, ast.Assign)
                and isinstance(n.targets[0], ast.Name)
                and n.targets[0].id == "diverged")
    code = compile(ast.Expression(node.value), "<main.py>", "eval")
    return lambda loss: eval(code, {}, {"loss": loss})


@pytest.mark.parametrize("loss", [float("nan"), float("inf"),
                                  float("-inf"), 0.5, -3.0, 0.0, None])
def test_the_divergence_test_is_main_py_s(loss):
    want = _jax_divergence_test()(loss)
    assert cli.diverged_loss(loss) is want
    assert want is (loss is not None and (math.isnan(loss)
                                          or loss == float("inf")))


def _diverging_settings(click_model_json):
    return {
        "train_input_feed": "ClickSimulationFeed",
        "train_input_hparams": f"click_model_json={click_model_json}",
        "valid_input_feed": "DirectLabelFeed", "valid_input_hparams": "",
        "ranking_model": "DNN", "ranking_model_hparams":
            "hidden_layer_sizes=[16]",
        "learning_algorithm": "DLA",
        # An absurd step and no clip: the loss is nan after one window.
        "learning_algorithm_hparams":
            "learning_rate=1e38,max_gradient_norm=0,grad_strategy=sgd",
        "metrics": ["ndcg"], "metrics_topn": [5],
        "objective_metric": "ndcg_5", "selection_bias_cutoff": 5,
    }


def test_a_diverged_run_saves_its_final_state_as_main_py(
        toy_data_dir, click_model_json, tmp_path, capsys):
    import main as jax_main

    setting_file = tmp_path / "settings.json"
    setting_file.write_text(json.dumps(_diverging_settings(
        click_model_json)))
    common = ["--data_dir", toy_data_dir, "--setting_file",
              str(setting_file), "--batch_size", "8",
              "--max_train_iteration", "6", "--steps_per_checkpoint", "2"]
    lines, steps = {}, {}
    for name, run in (("port", lambda a: cli.main(a + ["--device", "cpu"])),
                      ("jax", lambda a: jax_main.main(a + ["--dp", "off"]))):
        model_dir = tmp_path / name
        capsys.readouterr()
        run(common + ["--model_dir", str(model_dir)])
        out = capsys.readouterr().out.splitlines()
        lines[name] = [line.split(" (")[0] for line in out
                       if line.startswith(("step ", "Divergence",
                                           "Training done", "  saved"))]
        ckpt = model_dir / "DLA.ckpt.npz"
        assert ckpt.is_file(), f"{name}: no checkpoint after a divergence"
        steps[name] = ckpt_lib.read_metadata(str(model_dir / "DLA.ckpt"))[
            "step"]
        with np.load(ckpt) as arrays:
            assert arrays.files
    assert lines["port"] == lines["jax"]
    assert lines["port"][0].startswith("step 2 loss nan")
    assert "Divergence detected" in lines["port"]
    assert steps["port"] == steps["jax"] == 4
