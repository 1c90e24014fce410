"""The data-parallel training window as the graph captures it, on the CPU.

On the card a data-parallel rank under NCCL replays its window as one CUDA
graph (``run/window.WindowGraphs`` with the cross-rank mean and this
rank's shard generator); a gloo rank and the CPU run the window eagerly
(``parallel.dp_train_steps``). Here, without a card:

* the graphs' persistent shard generator, reseeded before each window,
  holds what ``parallel.shard_generator``'s fresh one holds, over three
  windows at ranks 0 and 1; one rank registers one generator;
* two gloo ranks run two windows eagerly and through the body the graph
  captures (run eagerly, reseeded as a replay reseeds): state, data key
  and window metrics bit for bit, and the same on both ranks;
* ``Experiment.eager_reason`` gives a reason on the CPU and on a gloo
  group and none on NCCL (the group mocked), the CLI's line says which,
  and ``train_steps_device`` sends an NCCL rank's window to the graphs
  with the rank's hooks, and ``fuse_window=False`` to the eager window.

The graph itself needs the card: ``tests/test_torch_dp_window_gpu.py``.
"""

import os
from functools import partial

import numpy as np
import pytest
import torch

from ultra_pytorch_tpu_torch.parallel import (
    all_reduce_mean, shard_generator, shard_seed, spawn_ranks)
from ultra_pytorch_tpu_torch.run import experiment as experiment_lib
from ultra_pytorch_tpu_torch.run.experiment import Experiment
from ultra_pytorch_tpu_torch.run.window import WindowGraphs

import torch_dp_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLICK_JSON = os.path.join(REPO, "example", "ClickModel",
                          "pbm_0.1_1.0_4_1.0.json")
WORLD = 2
STEPS, WINDOWS = 2, 2


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _settings(algo, feed="ClickSimulationFeed"):
    online = algo in ("MGD", "NSGD")
    return {"train_input_feed": feed,
            "train_input_hparams": f"click_model_json={CLICK_JSON}",
            "valid_input_feed": "DirectLabelFeed", "valid_input_hparams": "",
            "test_input_feed": "DirectLabelFeed", "test_input_hparams": "",
            "ranking_model": "DNN",
            "ranking_model_hparams": "hidden_layer_sizes=[8]",
            "learning_algorithm": algo,
            "learning_algorithm_hparams":
                f"click_model_json={CLICK_JSON}" if online else "",
            "metrics": ["ndcg"], "metrics_topn": [5],
            "objective_metric": "ndcg_5", "selection_bias_cutoff": 5}


# Regression-EM draws its uniforms from the shard generator; MGD and NSGD
# their noises from the replica one and their batches from the shard one.
BODY = {"DLA": _settings("DLA"),
        "RegressionEM": _settings("RegressionEM"),
        "MGD": _settings("MGD", "StochasticOnlineSimulationFeed"),
        "NSGD": _settings("NSGD", "StochasticOnlineSimulationFeed")}


def _experiment(toy_data_dir, algo="DLA"):
    exp = Experiment(dict(BODY[algo]), toy_data_dir, "unused", batch_size=8,
                     seed=3, device="cpu")
    exp.setup()
    exp.init_state()
    return exp


# -- the shard generator ---------------------------------------------------

@pytest.mark.parametrize("rank", [0, 1])
def test_persistent_shard_generator_draws_as_the_fresh_one(toy_data_dir,
                                                           rank):
    exp = _experiment(toy_data_dir)
    graphs = WindowGraphs(exp.algorithm, exp.feeds["train"], exp.state,
                          exp._generator, sync=all_reduce_mean,
                          shard_seed=partial(shard_seed, rank=rank))
    assert graphs.generators == [exp._generator, graphs.shard]
    seeds = []
    for _ in range(3):
        seed = exp._window_seed()
        seeds.append(seed)
        graphs.reseed(seed)
        fresh = shard_generator(torch.Generator().manual_seed(seed), rank,
                                WORLD)
        assert graphs.generator.initial_seed() == seed
        assert torch.equal(graphs.shard.get_state(), fresh.get_state())
        assert torch.equal(torch.rand(64, generator=graphs.shard),
                           torch.rand(64, generator=fresh))
        assert torch.equal(torch.randint(0, 1 << 30, (8,),
                                         generator=graphs.shard),
                           torch.randint(0, 1 << 30, (8,), generator=fresh))
    # The other rank's stream differs from this one's.
    other = shard_generator(torch.Generator().manual_seed(seeds[-1]),
                            1 - rank, WORLD)
    graphs.reseed(seeds[-1])
    assert not torch.equal(graphs.shard.get_state(), other.get_state())


def test_one_rank_registers_one_generator(toy_data_dir):
    exp = _experiment(toy_data_dir)
    graphs = WindowGraphs(exp.algorithm, exp.feeds["train"], exp.state,
                          exp._generator, sync=all_reduce_mean)
    assert graphs.shard is None and graphs.generators == [exp._generator]
    exp.data_parallel, exp.world_size, exp.rank = True, 1, 0
    assert exp._dp_hooks() == {"sync": all_reduce_mean}
    exp.world_size, exp.rank = WORLD, 1
    hooks = exp._dp_hooks()
    assert hooks["sync"] is all_reduce_mean
    assert hooks["shard_seed"](12345) == shard_seed(12345, 1)
    exp.data_parallel = False
    assert exp._dp_hooks() == {}


# -- two gloo ranks: the graph's body against the eager window -------------

@pytest.fixture(scope="module")
def body_ranks(toy_data_dir, tmp_path_factory):
    store = tmp_path_factory.mktemp("rendezvous") / "store"
    jobs = {name: (settings, STEPS, WINDOWS)
            for name, settings in BODY.items()}
    return spawn_ranks(torch_dp_ranks.rank_job, WORLD,
                       (f"file://{store}", {}, toy_data_dir, {}, "cpu", (),
                        jobs), timeout=180)


@pytest.mark.parametrize("algo", list(BODY))
def test_graph_body_equals_the_eager_window(body_ranks, algo):
    for result in body_ranks:
        eager, body = result[algo]["eager"], result[algo]["graph body"]
        assert body["metrics"] == eager["metrics"]
        assert body["step"] == eager["step"] == STEPS * WINDOWS
        np.testing.assert_array_equal(body["key"], eager["key"])
        assert len(body["leaves"]) == len(eager["leaves"])
        for a, b in zip(body["leaves"], eager["leaves"]):
            np.testing.assert_array_equal(a, b)
    # Replicated state and averaged metrics: the same on both ranks.
    a, b = (r[algo]["graph body"] for r in body_ranks)
    assert a["metrics"] == b["metrics"]
    for x, y in zip(a["leaves"], b["leaves"]):
        np.testing.assert_array_equal(x, y)


# -- which windows are captured ---------------------------------------------

def _as_rank_on_the_card(exp, backend, world=WORLD, rank=1):
    """Pretend `exp` is rank `rank` of a `backend` group on a card."""
    exp.device = torch.device("cuda")
    exp.data_parallel, exp.world_size, exp.rank = True, world, rank
    exp.backend = backend


def test_eager_reason_on_the_cpu_gloo_and_nccl(toy_data_dir):
    exp = _experiment(toy_data_dir)
    assert exp.backend is None
    assert exp.eager_reason() == "CUDA graphs exist only on the card"
    _as_rank_on_the_card(exp, "gloo")
    assert "gloo" in exp.eager_reason()
    assert "cannot be captured" in exp.eager_reason()
    exp.backend = "nccl"
    assert exp.eager_reason() is None
    exp.data_parallel = False
    assert exp.eager_reason() is None


@pytest.mark.parametrize("backend", ["gloo", "nccl"])
def test_the_cli_line_tells_gloo_from_nccl(toy_data_dir, capsys, backend):
    exp = _experiment(toy_data_dir)
    _as_rank_on_the_card(exp, backend, rank=0)
    exp._report_windows()
    exp._report_windows()   # once a run
    out = capsys.readouterr().out
    assert out.count("Training windows:") == 1
    if backend == "nccl":
        assert ("Training windows: captured CUDA graphs, one a window "
                "length, the all-reduces inside") in out
    else:
        assert ("Training windows: eager (data parallelism over gloo: its "
                "collectives run on the host and cannot be captured)") in out


class _Graphs:
    """Stands in for ``WindowGraphs``: records its arguments and runs."""

    made = []

    def __init__(self, algorithm, feed, state, generator, **hooks):
        self.state, self.hooks, self.runs = state, hooks, []
        _Graphs.made.append(self)

    def run(self, seed, num_steps):
        self.runs.append((seed, num_steps))
        return ["loss"], torch.zeros(1)


def test_an_nccl_rank_sends_its_window_to_the_graphs(toy_data_dir,
                                                     monkeypatch):
    exp = _experiment(toy_data_dir)
    _as_rank_on_the_card(exp, "nccl")
    _Graphs.made = []
    monkeypatch.setattr(experiment_lib, "WindowGraphs", _Graphs)
    eager = []
    monkeypatch.setattr(
        experiment_lib.mesh, "dp_train_steps",
        lambda alg, feed, state, gen, n: (eager.append((gen.initial_seed(),
                                                        n))
                                          or (state, ["loss"],
                                              torch.zeros(1))))
    seeds = [experiment_lib._key_seed(exp._data_key)]
    exp.train_steps_device(3)
    seeds.append(experiment_lib._key_seed(exp._data_key))
    exp.train_steps_device(3)
    seeds.append(experiment_lib._key_seed(exp._data_key))
    exp.train_steps_device(2, fuse_window=False)
    assert len(_Graphs.made) == 1
    graphs = _Graphs.made[0]
    assert graphs.runs == [(seeds[0], 3), (seeds[1], 3)]
    assert graphs.hooks["sync"] is all_reduce_mean
    assert graphs.hooks["shard_seed"](7) == shard_seed(7, 1)
    assert eager == [(seeds[2], 2)]
    # A gloo rank's window is eager, whatever fuse_window says.
    exp.backend = "gloo"
    exp.train_steps_device(1)
    assert len(eager) == 2 and len(graphs.runs) == 2
