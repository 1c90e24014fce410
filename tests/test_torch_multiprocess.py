"""The port's data-parallel CLI across processes: the counterpart of
``tests/test_multihost.py``.

* Two CPU processes started by ``run/launch.py`` under
  ``ULTRA_COORDINATOR`` (a ``file://`` store), ``ULTRA_NUM_PROCESSES`` and
  ``ULTRA_PROCESS_ID`` train as one run: both print the banner and the
  same loss and metric lines, one checkpoint is written, and it restores
  in a single-process ``--test_only`` and in the JAX package's reader.
* ``--dp 2`` from one command spawns its two ranks, with ``--shard_data``
  and ``--profile_steps`` (rank 0 alone writes the trace).
* ``--profile_steps`` on one process writes a ``torch.profiler`` trace.
"""

import json
import os
import re

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX package is the reference here
pytest.importorskip("flax")  # its algorithms need it

from ultra_pytorch_tpu.run.experiment import (  # noqa: E402
    Experiment as JaxExperiment)
from ultra_pytorch_tpu_torch.run import __main__ as cli  # noqa: E402
from ultra_pytorch_tpu_torch.run import launch  # noqa: E402
from ultra_pytorch_tpu_torch.run.experiment import Experiment  # noqa: E402

BANNER = "Data parallelism: 2-device mesh"


@pytest.fixture(autouse=True)
def _one_thread(monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")   # for the ranks


def _settings(click_model_json):
    return {
        "train_input_feed": "ClickSimulationFeed",
        "train_input_hparams": f"click_model_json={click_model_json}",
        "valid_input_feed": "DirectLabelFeed", "valid_input_hparams": "",
        "test_input_feed": "DirectLabelFeed", "test_input_hparams": "",
        "ranking_model": "DNN", "ranking_model_hparams":
            "hidden_layer_sizes=[16]",
        "learning_algorithm": "DLA", "learning_algorithm_hparams": "",
        "metrics": ["ndcg", "mrr"], "metrics_topn": [3, 5],
        "objective_metric": "ndcg_5", "selection_bias_cutoff": 5}


def _common(tmp_path, data_dir, click_model_json):
    setting_file = tmp_path / "settings.json"
    setting_file.write_text(json.dumps(_settings(click_model_json)))
    return ["--data_dir", data_dir, "--setting_file", str(setting_file),
            "--model_dir", str(tmp_path / "model"), "--batch_size", "8"]


def _step_lines(text):
    """The step lines without their wall-clock rate."""
    return [re.sub(r"\(\d+ queries/s\)", "", line)
            for line in text.splitlines() if line.startswith("step ")]


def test_two_processes_train_as_one_run(tmp_path, toy_data_dir,
                                        click_model_json, capsys):
    common = _common(tmp_path, toy_data_dir, click_model_json)
    out = launch.launch(common + ["--max_train_iteration", "8",
                                  "--steps_per_checkpoint", "4"],
                        processes=2, device="cpu",
                        log_dir=str(tmp_path / "logs"), timeout=120)
    assert out["returncodes"] == [0, 0], out["tails"]
    assert all(f"{BANNER} (2 host(s))" in t for t in out["tails"])
    lines = [_step_lines(t) for t in out["tails"]]
    assert len(lines[0]) == 2 and lines[0] == lines[1], out["tails"]
    model_dir = tmp_path / "model"
    assert sorted(f for f in os.listdir(model_dir)
                  if f.endswith(".ckpt.npz")) == ["DLA.ckpt.npz"]

    # The checkpoint restores in one process of the port...
    cli.main(common + ["--device", "cpu", "--test_only",
                       "--output_dir", str(tmp_path / "out")])
    text = capsys.readouterr().out
    assert "Restored checkpoint from" in text and BANNER not in text
    assert (tmp_path / "out" / "test.ranklist").is_file()
    # ... and in the JAX package's reader, leaf for leaf.
    settings = _settings(click_model_json)
    exp = Experiment(dict(settings), toy_data_dir, str(model_dir),
                     batch_size=8, device="cpu").setup()
    exp.init_state()
    assert exp.restore() and exp.state.step == 8
    jexp = JaxExperiment(dict(settings), toy_data_dir, str(model_dir),
                         batch_size=8, dp="off").setup()
    jexp.init_state()
    assert jexp.restore()
    theirs = [np.asarray(x) for x in jax.tree_util.tree_leaves(
        (jexp.state, jexp._data_rng))]
    mine = exp.algorithm.state_leaves(exp.state) + [exp._data_key]
    assert len(mine) == len(theirs)
    for a, b in zip(mine, theirs):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_dp_from_one_command_spawns_its_ranks(tmp_path, toy_data_dir,
                                              click_model_json, capfd):
    common = _common(tmp_path, toy_data_dir, click_model_json)
    cli.main(common + ["--device", "cpu", "--dp", "2", "--shard_data",
                       "--profile_steps", "2", "--max_train_iteration", "6",
                       "--steps_per_checkpoint", "4"])
    text = capfd.readouterr().out
    assert text.count(f"{BANNER} (1 host(s))") == 1   # rank 0 prints
    assert [line.split()[1] for line in _step_lines(text)] == ["6"]
    assert "Training done at step 6" in text
    model_dir = tmp_path / "model"
    assert (model_dir / "DLA.ckpt.npz").is_file()
    assert sorted(os.listdir(model_dir / "profile")) == ["spans.json",
                                                         "trace.json"]
    logged = (model_dir / "logs" / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(r)["split"] for r in logged] == ["train", "valid"]


def test_profile_steps_writes_a_trace(tmp_path, toy_data_dir,
                                      click_model_json, capsys):
    common = _common(tmp_path, toy_data_dir, click_model_json)
    cli.main(common + ["--device", "cpu", "--profile_steps", "3",
                       "--max_train_iteration", "7",
                       "--steps_per_checkpoint", "4"])
    text = capsys.readouterr().out
    assert "step 7 loss" in text and "Training done at step 7" in text
    trace = json.loads((tmp_path / "model" / "profile" /
                        "trace.json").read_text())
    assert any("train" in str(e.get("name", "")) or e.get("ph") == "X"
               for e in trace["traceEvents"])
