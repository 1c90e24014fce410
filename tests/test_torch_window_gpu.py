"""Training windows as replayed CUDA graphs on the card (``run/window.py``):
a graph window equals the eager window bit for bit, the launch counters
count what the replays run, a host read under capture raises, and no
garbage collection runs under capture (one could destroy another graph,
which capture refuses).

These need a CUDA device and skip without one. The file imports nothing
of JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_*.py -q
"""

import gc
import os

import numpy as np
import pytest
import torch

from ultra_pytorch_tpu_torch.data.dataset import RankingDataset
from ultra_pytorch_tpu_torch.run.experiment import Experiment
from ultra_pytorch_tpu_torch.run.window import capture, read_launches
from ultra_pytorch_tpu_torch.utils import spans

pytestmark = pytest.mark.gpu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLICK_JSON = os.path.join(REPO, "example", "ClickModel",
                          "pbm_0.1_1.0_4_1.0.json")
F, L, B, STEPS = 16, 5, 16, 6


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


def _settings(algorithm, ranker="DNN", ranker_hparams=""):
    kernels = ranker == "DNN"
    hp = ("hidden_layer_sizes=[32, 16],use_pallas=true" if kernels
          else ranker_hparams)
    return {
        "train_input_feed": "ClickSimulationFeed",
        "train_input_hparams": f"click_model_json={CLICK_JSON},"
                               "use_pallas_click=true",
        "valid_input_feed": "DirectLabelFeed", "valid_input_hparams": "",
        "ranking_model": ranker, "ranking_model_hparams": hp,
        "learning_algorithm": algorithm,
        "learning_algorithm_hparams":
            "loss_func=fused_softmax_loss" if algorithm == "DLA" else "",
        "metrics": ["ndcg"], "metrics_topn": [3, 5],
        "objective_metric": "ndcg_5", "selection_bias_cutoff": L,
    }


def _experiment(settings, dev, tmp_path):
    exp = Experiment(dict(settings), "unused", str(tmp_path), batch_size=B,
                     device=dev)
    exp.setup(datasets={"train": _data(64, 0), "valid": _data(40, 1)})
    exp.init_state()
    return exp


@pytest.mark.parametrize("algorithm,ranker,hparams", [
    ("DLA", "DNN", ""),
    ("RegressionEM", "DNN", ""),
    ("DLA", "SetRank", "d_model=16,num_heads=2,num_layers=1,diff=8,"
                       "rate=0.1"),
], ids=["dla", "regression_em", "setrank_dropout"])
def test_graph_window_equals_the_eager_window(cuda, tmp_path, algorithm,
                                              ranker, hparams):
    """Two windows of each length (a window and its tail): the state, the
    data key and the window metrics bit for bit. Regression-EM's uniforms
    and SetRank's dropout masks come from the registered generator."""
    settings = _settings(algorithm, ranker, hparams)
    runs = []
    for fuse in (False, True):
        exp = _experiment(settings, cuda, tmp_path)
        metrics = [exp.train_steps(n, fuse) for n in (STEPS, STEPS, 4, 4)]
        runs.append((exp.algorithm.state_leaves(exp.state) + [exp._data_key],
                     metrics))
        if fuse:
            assert exp.eager_reason() is None
            assert sorted(exp._window_graphs.graphs) == [4, STEPS]
    (eager, eager_metrics), (graph, graph_metrics) = runs
    assert graph_metrics == eager_metrics
    assert len(graph) == len(eager)
    for a, b in zip(graph, eager):
        np.testing.assert_array_equal(a, b)


def test_launch_counts_are_the_captured_counts_times_the_replays(cuda,
                                                                 tmp_path):
    exp = _experiment(_settings("DLA"), cuda, tmp_path)
    before = read_launches()
    exp.train_steps(STEPS)          # captured, then replayed once
    graph = exp._window_graphs.graphs[STEPS][0]
    launches = [graph.counts.get(k, 0) for k in spans.KERNEL_LAUNCHES]
    assert [a - b for a, b in zip(read_launches(), before)] == launches
    # K1 and K2 once a step, K3 and K4 twice (DLA's two losses), K5 once.
    assert launches == [STEPS, STEPS, 2 * STEPS, 2 * STEPS, 1]
    for _ in range(2):
        exp.train_steps(STEPS)
    assert [a - b for a, b in zip(read_launches(), before)] == [
        3 * n for n in launches]


def test_a_host_read_under_capture_raises(cuda, tmp_path):
    """A step that reads a value back to the host cannot be captured: the
    window raises and does not run eager."""
    exp = _experiment(_settings("DLA"), cuda, tmp_path)
    metrics = exp.algorithm.metrics

    def reading(out):
        float(out[0].detach())   # a host read inside the step
        return metrics(out)

    exp.algorithm.metrics = reading
    with pytest.raises(RuntimeError):
        exp.train_steps(STEPS)
    torch.cuda.synchronize()


def test_no_garbage_collection_under_capture(cuda):
    """A Scorer dropped in a reference cycle holds its bucket graphs until
    a collection; one that ran under another capture would destroy a
    graph there and fail that capture. The warm-up runs with collections
    on, the capture with them off, and they are on again after."""
    x = torch.ones(4, device=cuda)
    seen = []

    def fn():
        seen.append((torch.cuda.is_current_stream_capturing(),
                     gc.isenabled()))
        return x * 2

    assert gc.isenabled()
    graph, out = capture(fn)
    assert seen == [(False, True), (True, False)] and gc.isenabled()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, x * 2)
