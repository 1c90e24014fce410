"""Data-parallel training windows as replayed CUDA graphs on the card.

* NCCL at world size 1: a rank's windows are captured (``eager_reason``
  is None), the all-reduces inside the graph, and two graph windows equal
  two eager ones (``fuse_window=False``, ``parallel.dp_train_steps``) bit
  for bit, launches included; DLA's also equal the windows without a
  group.
* A window graph with a separate shard generator and no group (the
  second registered generator that one rank never has) equals the eager
  window whose algorithm draws from a fresh generator seeded the same.

These need a CUDA device and skip without one. The file imports nothing
of JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_*.py -q
"""

import os

import numpy as np
import pytest
import torch

from ultra_pytorch_tpu_torch.algorithms.base import train_window
from ultra_pytorch_tpu_torch.data.dataset import RankingDataset
from ultra_pytorch_tpu_torch.parallel import (
    close_data_parallel, init_data_parallel)
from ultra_pytorch_tpu_torch.run.experiment import Experiment
from ultra_pytorch_tpu_torch.run.window import WindowGraphs, read_launches

pytestmark = pytest.mark.gpu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLICK_JSON = os.path.join(REPO, "example", "ClickModel",
                          "pbm_0.1_1.0_4_1.0.json")
F, L, B, STEPS = 16, 5, 16, 6
SHARD_TAG = 0x5EED


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs exist only there)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _data(num_queries, seed):
    rng = np.random.default_rng(seed)
    d = num_queries * L
    labels = rng.integers(0, 3, size=(num_queries, L)).astype(np.float32)
    labels[:, 0] = np.maximum(labels[:, 0], 1.0)
    return RankingDataset(
        features=rng.normal(size=(d, F)).astype(np.float32),
        initial_list=np.arange(d, dtype=np.int64).reshape(num_queries, L),
        labels=labels, qids=[str(i) for i in range(num_queries)],
        dids=[f"d{i}" for i in range(d)], feature_size=F, rank_list_size=L,
        max_label=2.0)


def _settings(algorithm):
    online = algorithm == "MGD"
    feed = ("StochasticOnlineSimulationFeed" if online
            else "ClickSimulationFeed")
    clicks = "" if online else ",use_pallas_click=true"
    algo_hp = {"DLA": "loss_func=fused_softmax_loss",
               "MGD": f"click_model_json={CLICK_JSON}"}
    return {
        "train_input_feed": feed,
        "train_input_hparams": f"click_model_json={CLICK_JSON}{clicks}",
        "valid_input_feed": "DirectLabelFeed", "valid_input_hparams": "",
        "ranking_model": "DNN",
        "ranking_model_hparams": "hidden_layer_sizes=[32, 16],"
                                 "use_pallas=true",
        "learning_algorithm": algorithm,
        "learning_algorithm_hparams": algo_hp.get(algorithm, ""),
        "metrics": ["ndcg"], "metrics_topn": [3, 5],
        "objective_metric": "ndcg_5", "selection_bias_cutoff": L,
    }


def _experiment(settings, dev, tmp_path):
    """A rank of this process's group if it has one, else on one device."""
    exp = Experiment(dict(settings), "unused", str(tmp_path), batch_size=B,
                     device=dev)
    exp.setup(datasets={"train": _data(64, 0), "valid": _data(40, 1)})
    exp.init_state()
    return exp


def _run(settings, dev, tmp_path, fuse):
    """Two windows of STEPS steps: (state leaves and data key, window
    metrics, launches)."""
    exp = _experiment(settings, dev, tmp_path)
    before = read_launches()
    metrics = [exp.train_steps(STEPS, fuse) for _ in range(2)]
    launches = [a - b for a, b in zip(read_launches(), before)]
    return exp, (exp.algorithm.state_leaves(exp.state) + [exp._data_key],
                 metrics, launches)


def _same(a, b):
    (a_leaves, a_metrics, a_launches), (b_leaves, b_metrics, b_launches) = \
        a, b
    assert a_metrics == b_metrics and a_launches == b_launches
    assert len(a_leaves) == len(b_leaves)
    for x, y in zip(a_leaves, b_leaves):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("algorithm", ["DLA", "RegressionEM", "MGD"])
def test_nccl_world_size_one_graph_window_equals_eager(cuda, tmp_path,
                                                        algorithm):
    settings = _settings(algorithm)
    solo = _run(settings, cuda, tmp_path / "solo", True)[1]
    init_data_parallel(1, 0, cuda,
                       init_method=f"file://{tmp_path / 'store'}")
    try:
        graph_exp, graph = _run(settings, cuda, tmp_path / "graph", True)
        eager_exp, eager = _run(settings, cuda, tmp_path / "eager", False)
    finally:
        close_data_parallel()
    assert graph_exp.data_parallel and graph_exp.world_size == 1
    assert graph_exp.eager_reason() is None
    assert graph_exp._window_graphs.sync is not None
    assert graph_exp._window_graphs.generators == [graph_exp._generator]
    assert eager_exp._window_graphs is None
    _same(graph, eager)
    if algorithm == "DLA":
        _same(graph, solo)


@pytest.mark.parametrize("algorithm", ["RegressionEM", "MGD"])
def test_window_graph_with_a_shard_generator_equals_eager(cuda, tmp_path,
                                                           algorithm):
    """Regression-EM's uniforms and MGD's batches come from the shard
    generator, its noises from the replica one."""
    def shard(seed):
        return seed ^ SHARD_TAG

    settings = _settings(algorithm)
    runs = []
    for fuse in (False, True):
        exp = _experiment(settings, cuda, tmp_path / str(fuse))
        feed, gen = exp.feeds["train"], exp._generator
        graphs = WindowGraphs(exp.algorithm, feed, exp.state, gen,
                              shard_seed=shard)
        metrics = []
        for _ in range(2):
            seed = exp._window_seed()
            if fuse:
                keys, means = graphs.run(seed, STEPS)
            else:
                exp.algorithm.shard_generator = torch.Generator(
                    device=cuda).manual_seed(shard(seed))
                _, keys, means = train_window(exp.algorithm, feed, exp.state,
                                              gen.manual_seed(seed), STEPS)
                exp.algorithm.shard_generator = None
            metrics.append(dict(zip(keys, means.tolist())))
        runs.append((exp.algorithm.state_leaves(exp.state) + [exp._data_key],
                     metrics, []))
        if fuse:
            assert len(graphs.generators) == 2
    _same(runs[1], runs[0])
    # The shard generator's draws matter: without it the run differs.
    plain = _run(settings, cuda, tmp_path / "plain", True)[1]
    assert plain[1] != runs[1][1]
